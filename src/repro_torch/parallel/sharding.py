"""Logical-axis sharding for the port, counterpart of
``repro.parallel.sharding``: a rule set maps logical activation and
parameter axes to the axes of a mesh.

Logical axes (as the reference's):
    batch     -> ("pod", "data") on the multi-pod mesh, ("data",) single-pod
    heads     -> "model"   (when the head count divides the model axis)
    kv_heads  -> "model"   (likewise)
    ffn       -> "model"
    experts   -> "model"   (expert parallelism)
    vocab     -> "model"
    seq_model -> None      ("model" under the sequence-parallel override)
    fsdp      -> "data"

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dimensions, or an :func:`abstract_mesh` (names and sizes only, no process
group), which is all the spec functions need.  A spec is a :class:`P`, a
tuple of axis names, tuples of names or ``None`` a tensor dim; it compares
with JAX's ``PartitionSpec`` by ``tuple(spec)``.  A spec becomes a
DTensor's placements by :func:`spec_placements`: ``Shard(d)`` on each mesh
dim that names tensor dim d, ``Replicate()`` on the others.

The reference's model layers call ``shard()`` as GSPMD hints; GSPMD then
partitions every op.  torch has no partitioner to act on a hint, so the
port's parallelism is explicit: the steps on a mesh (``training.train_step``)
set rules that carry :class:`~repro_torch.parallel.collectives.Shards`
(``AxisRules.shards``), and under them each block gathers its params'
shards, every family's layers, embedding and loss split heads, width, ffn
and vocab over ``"model"`` where the rules map them there, and the MoE
takes its expert-parallel route (``models.layers``, ``models.transformer``,
``parallel.collectives``).  ``shard`` itself redistributes a DTensor to
the spec's placements and leaves a plain tensor as it is.

``shard_map_compat`` runs a function on each rank's local shards, as
``jax.shard_map`` does: inputs are cut (a plain tensor, which every rank
holds whole) or redistributed (a DTensor) to their specs, and the outputs
become DTensors of the out specs.  The collectives inside are the
caller's (``torch.distributed`` over ``mesh.get_group(axis)``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

__all__ = [
    "AbstractMesh",
    "AxisRules",
    "P",
    "abstract_mesh",
    "axis_rules",
    "current_rules",
    "local_shard",
    "make_rules",
    "mesh_axes",
    "place",
    "shard",
    "shard_map_compat",
    "spec_placements",
    "tree_map_with_path",
]

_STATE = threading.local()


class P:
    """A partition spec: one entry a tensor dim, each an axis name, a tuple
    of names (the tensor dim split over those axes, major first) or None
    (not split).  A one-name tuple becomes the name, as in JAX."""

    __slots__ = ("_parts",)

    def __init__(self, *parts):
        self._parts = tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else p for p in parts)

    def __iter__(self):
        return iter(self._parts)

    def __len__(self) -> int:
        return len(self._parts)

    def __getitem__(self, i):
        return self._parts[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, P) and self._parts == other._parts

    def __hash__(self) -> int:
        return hash(self._parts)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self._parts)) + ")"


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes of a mesh, with no devices and no process group."""

    axis_sizes: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))


def abstract_mesh(axis_sizes, axis_names) -> AbstractMesh:
    return AbstractMesh(tuple(axis_sizes), tuple(axis_names))


def mesh_axes(mesh) -> dict:
    """{axis name: size} in the mesh's dim order, for a DeviceMesh or an
    AbstractMesh."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    if not mesh.mesh_dim_names:
        raise ValueError("the mesh's dimensions have no names (init_device_mesh(mesh_dim_names=))")
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


class AxisRules:
    """``mapping``: logical axis -> mesh axis (or a tuple, or None).
    ``shards``: a step's :class:`~repro_torch.parallel.collectives.Shards`
    when the params the layers see are this rank's shards, else None."""

    def __init__(self, mesh, mapping: dict[str, object], shards=None):
        self.mesh = mesh
        self.mapping = dict(mapping)
        self.shards = shards

    def resolve(self, name: Optional[str]):
        if name is None:
            return None
        return self.mapping.get(name)

    def spec(self, *names) -> P:
        return P(*[self.resolve(n) for n in names])


def make_rules(mesh, cfg=None, overrides: Optional[dict] = None) -> AxisRules:
    """cfg (a ModelConfig) gates the head axes by divisibility, as the
    reference does (a head count the model axis does not divide stays
    replicated), unless ``cfg.force_head_sharding``."""
    axes = mesh_axes(mesh)
    batch = tuple(a for a in ("pod", "data") if a in axes) or None
    fsdp = "data" if "data" in axes else None
    msize = axes.get("model", 1)

    def fits(n: Optional[int]) -> Optional[str]:
        if "model" not in axes:
            return None
        if cfg is None or n is None:
            return "model"
        return "model" if (n % msize == 0) else None

    n_heads = getattr(cfg, "n_heads", None)
    n_kv = getattr(cfg, "n_kv_heads", None)
    force = bool(getattr(cfg, "force_head_sharding", False))
    mapping = {
        "batch": batch,
        "heads": ("model" if ("model" in axes and force) else fits(n_heads)),
        "kv_heads": fits(n_kv),
        "ffn": "model" if "model" in axes else None,
        "experts": "model" if "model" in axes else None,
        "vocab": "model" if "model" in axes else None,
        "seq_model": None,  # flipped to "model" by the sequence-parallel lever
        "fsdp": fsdp,
    }
    if overrides:
        mapping.update(overrides)
    return AxisRules(mesh, mapping)


def current_rules() -> Optional[AxisRules]:
    return getattr(_STATE, "rules", None)


@contextlib.contextmanager
def axis_rules(rules: Optional[AxisRules]):
    prev = current_rules()
    _STATE.rules = rules
    try:
        yield
    finally:
        _STATE.rules = prev


def spec_placements(mesh, spec: P, axis_names=None) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``, one a mesh dim:
    ``Shard(d)`` where tensor dim d names the mesh dim (restricted to
    ``axis_names`` when given), else ``Replicate()``."""
    out = []
    for name in mesh_axes(mesh):
        dims = [d for d, part in enumerate(spec)
                if part == name or (isinstance(part, tuple) and name in part)]
        if len(dims) > 1:
            raise ValueError(f"{spec}: mesh axis {name!r} names more than one tensor dim")
        manual = axis_names is None or name in axis_names
        out.append(Shard(dims[0]) if dims and manual else Replicate())
    return tuple(out)


def local_shard(x: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's piece of the whole tensor ``x`` under ``placements``
    (``torch.chunk``'s split, mesh dims in order), with no communication."""
    coord = mesh.get_coordinate()
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            n, length = mesh.size(i), x.shape[pl.dim]
            size = -(-length // n)
            start = min(coord[i] * size, length)
            x = x.narrow(pl.dim, start, min(size, length - start))
    return x


def place(x: torch.Tensor, mesh, placements) -> DTensor:
    """The whole tensor ``x``, which every rank holds, as a DTensor on
    ``mesh`` with ``placements`` (each rank keeps its own piece: a copy
    where the piece is smaller than the whole, which can then be freed)."""
    local = local_shard(x, mesh, placements)
    if local.numel() != x.numel():
        local = local.clone()
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=x.shape,
                              stride=x.stride())


def shard(x: torch.Tensor, *names) -> torch.Tensor:
    """Place ``x`` by logical axis names (None = a dim not split).  A no-op
    without active rules; under rules a DTensor is redistributed to the
    spec's placements and a plain tensor is returned as it is."""
    rules = current_rules()
    if rules is None:
        return x
    if len(names) != x.ndim:
        raise ValueError(f"shard(): {len(names)} names for rank-{x.ndim} array")
    if isinstance(x, DTensor):
        return x.redistribute(x.device_mesh, spec_placements(x.device_mesh, rules.spec(*names)))
    return x


def tree_map_with_path(fn, tree, path: tuple = ()):
    """``fn(path, leaf)`` over ``tree``: dicts, lists, tuples and dataclass
    instances (the caches' containers) are nodes, ``None`` holds no leaf.
    ``path`` holds the keys from the root: dict keys, list indices and
    dataclass field names."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: tree_map_with_path(fn, getattr(tree, f.name), path + (f.name,))
                             for f in dataclasses.fields(tree)})
    if tree is None:
        return None
    return fn(path, tree)


def _map_spec(fn, tree, spec):
    """``fn(leaf, spec)`` over ``tree``, where ``spec`` is a P for the whole
    subtree or a tree of the same structure (JAX's spec prefixes)."""
    if isinstance(spec, P):
        if isinstance(tree, dict):
            return {k: _map_spec(fn, v, spec) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(_map_spec(fn, v, spec) for v in tree)
        return fn(tree, spec)
    if isinstance(spec, dict):
        return {k: _map_spec(fn, tree[k], spec[k]) for k in tree}
    return type(tree)(_map_spec(fn, t, s) for t, s in zip(tree, spec, strict=True))


def shard_map_compat(
    f, *, mesh, in_specs, out_specs, check_vma: bool = True, axis_names=None
):
    """``f`` over each rank's local shards of its inputs, its outputs
    DTensors of ``out_specs`` (JAX's ``shard_map``).  ``axis_names``: the
    manual axes (default all); inputs stay whole along the others.
    ``check_vma`` is accepted and not checked: an out spec that claims
    replication is trusted, as JAX's ``check_vma=False`` does."""

    def local(x, spec):
        if not isinstance(x, torch.Tensor):
            return x
        pl = spec_placements(mesh, spec, axis_names)
        if isinstance(x, DTensor):
            return x.redistribute(mesh, pl).to_local()
        return local_shard(x, mesh, pl)

    def whole(x, spec):
        if not isinstance(x, torch.Tensor):
            return x
        return DTensor.from_local(x, mesh, spec_placements(mesh, spec, axis_names),
                                  run_check=False)

    def wrapped(*args):
        if isinstance(mesh, AbstractMesh):
            raise ValueError("shard_map_compat runs on a DeviceMesh, not an abstract mesh")
        return _map_spec(whole, f(*_map_spec(local, args, tuple(in_specs))), out_specs)

    return wrapped
