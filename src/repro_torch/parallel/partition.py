"""Parameter partition specs, counterpart of ``repro.parallel.partition``:
each leaf's spec follows from its name (the last dict key of its path) and
its rank.

Params are nested dicts (and lists for the unstacked prefix and tail
layers); stacked layer groups add a leading ``[G]`` dim, which maps to
``None``.  The fsdp axis is ("pod", "data") when ``cfg.dcn_fsdp`` and the
mesh has a pod axis (ZeRO-3 across pods, llama4-400b), else "data".

``param_shardings`` turns the specs into :class:`MeshSharding` leaves (a
DeviceMesh and its DTensor placements), which ``training.checkpoint``
restores leaves onto.  The specs are the reference's layout, and the
port's steps on a mesh hold each param, its gradient and its AdamW
moments as this rank's shard of them (``training.train_step``,
``parallel.collectives``): :func:`shard_shape` is that shard's shape,
JAX's ``NamedSharding.shard_shape``, which refuses a dim its axes do not
divide.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from ..configs.base import ModelConfig
from .sharding import P, mesh_axes, spec_placements, tree_map_with_path

__all__ = ["MeshSharding", "fsdp_axes_for", "model_axis", "param_shardings", "param_specs",
           "shard_shape", "spec_axes"]


@dataclasses.dataclass(frozen=True, eq=False)
class MeshSharding:
    """A leaf's place on a DeviceMesh (the reference's ``NamedSharding``):
    the mesh and one placement a mesh dim.  It unpacks as the pair
    ``(mesh, placements)``, and is one leaf of a tree (a tuple would be two)."""

    mesh: Any
    placements: tuple

    def __iter__(self):
        return iter((self.mesh, self.placements))


def spec_axes(spec: P) -> list:
    """The mesh axes that ``spec`` names, in its dims' order (a tuple's
    names major first)."""
    out = []
    for part in spec:
        out += [] if part is None else (list(part) if isinstance(part, tuple) else [part])
    return out


def shard_shape(shape, spec: P, mesh) -> tuple:
    """The shape of a rank's shard of a ``shape`` tensor placed by ``spec``
    (``NamedSharding(mesh, spec).shard_shape(shape)``); a ``ValueError``
    where a dim's axes do not divide it, as JAX's."""
    axes = mesh_axes(mesh)
    out = []
    for d, size in enumerate(shape):
        part = spec[d] if d < len(spec) else None
        n = 1
        for name in ([] if part is None else (part if isinstance(part, tuple) else (part,))):
            n *= axes[name]
        if size % n:
            raise ValueError(f"{spec} splits dim {d} of {tuple(shape)} {n} ways, which does not "
                             f"divide it")
        out.append(size // n)
    return tuple(out)


def fsdp_axes_for(cfg: ModelConfig, mesh):
    axes = mesh_axes(mesh)
    if "data" not in axes:
        return None
    if cfg.dcn_fsdp and "pod" in axes:
        return ("pod", "data")
    return "data"


# rules keyed by leaf name; the value is the base spec given the fsdp axis F
def _base_rule(name: str, ndim: int, F, in_moe: bool = False):
    M = "model"
    two = {
        "embed": (M, F),
        "head": (F, M),
        "wq": (F, M),
        "wk": (F, M),
        "wv": (F, M),
        "wr": (F, M),
        "wg": (F, M),
        "wu": (F, M),
        "wo": (M, F),
        "wd": (M, F),
        "w_dkv": (F, None),
        "w_krope": (F, None),
        "w_kup": (None, M),
        "w_vup": (None, M),
        "router": (F, None),
        "w_in_x": (F, M),
        "w_in_g": (F, M),
        "wa": (F, M),
        "wx": (F, M),
        "w_out": (M, F),
        "conv": (None, M),
        "w_lora_a": (F, None),
        "w_lora_b": (None, F),
        "cm_k": (F, M),
        "cm_v": (M, F),
        "cm_r": (F, M),
        "mix_rkvwg": (None, None),
        "cm_mix": (None, None),
        "decay_base": (None, None),
        "bonus_u": (None, None),
    }
    three = {  # expert-stacked weights [E, in, out] (only under a moe dict)
        "wg": (M, F, None),
        "wu": (M, F, None),
        "wd": (M, None, F),
    }
    if ndim == 1:
        return (None,)
    if in_moe and name in three:
        return three[name]
    if name in two:
        return two[name]
    return tuple([None] * ndim)


# the logical axis of the dim that _base_rule puts on "model", by leaf name,
# and by parent dict where a family names its leaves alike (RWKV6's wk, wv
# and wg split its heads; the MoE's expert stacks split its experts): a
# sharded step's compute reads that dim's piece where its rules map the axis
# to "model" (models.transformer._gather_block)
_MODEL_AXIS = {
    "embed": "vocab", "head": "vocab",
    "wq": "heads", "wo": "heads", "wk": "kv_heads", "wv": "kv_heads",
    "w_kup": "heads", "w_vup": "heads", "wr": "heads", "cm_r": "heads",
    "wg": "ffn", "wu": "ffn", "wd": "ffn", "cm_k": "ffn", "cm_v": "ffn",
    **dict.fromkeys(("w_in_x", "w_in_g", "wa", "wx", "conv", "w_out"), "lru_width"),
}
_MODEL_AXIS_UNDER = {"rwkv": dict.fromkeys(("wk", "wv", "wg"), "heads"),
                     "moe": dict.fromkeys(("wg", "wu", "wd"), "experts")}


def model_axis(path, leaf) -> str | None:
    """The logical axis of the dim of ``leaf`` (at ``path``) that its spec
    puts on ``"model"``, or None where the spec names no ``"model"``.  A
    leaf whose spec names it and that no table here gives an axis raises
    ``KeyError``."""
    if "model" not in spec_axes(_spec_for_leaf(path, leaf, None)):
        return None
    keys = [k for k in path if isinstance(k, str)]
    parent = keys[-2] if len(keys) > 1 else None
    return _MODEL_AXIS_UNDER.get(parent, {}).get(keys[-1]) or _MODEL_AXIS[keys[-1]]


def _spec_for_leaf(path, leaf, F) -> P:
    """``path``: the leaf's keys from the root (str dict keys, int list
    indices)."""
    keys = [k for k in path if isinstance(k, str)]
    name = keys[-1] if keys else None
    # expert weights live directly under a "moe" dict (shared experts are a
    # plain mlp under moe/shared and keep the 2D rules)
    in_moe = len(keys) >= 2 and keys[-2] == "moe"
    ndim = leaf.ndim
    base = _base_rule(name or "", ndim, F, in_moe=in_moe)
    if len(base) == ndim:
        return P(*base)
    if len(base) == ndim - 1:
        return P(None, *base)  # stacked blocks: leading group dim
    if len(base) == ndim - 2:
        return P(None, None, *base)
    return P(*([None] * ndim))


def param_specs(params, cfg: ModelConfig, mesh, vocab_dim_sharded: bool = True):
    """Tree of :class:`P` matching ``params`` (any leaves with ``ndim``:
    meta tensors will do).

    vocab_dim_sharded=False re-lays the embedding table as (None,
    d-sharded), the layout of the reference's compressed cross-pod step
    (its workaround for an XLA partitioner crash on vocab-sharded gathers).
    """
    F = fsdp_axes_for(cfg, mesh)
    axes = mesh_axes(mesh)

    def spec(path, leaf):
        if not vocab_dim_sharded and path and path[-1] == "embed":
            combo = (("data",) if "data" in axes else ()) + (("model",) if "model" in axes else ())
            return P(None, combo or None)
        return _spec_for_leaf(path, leaf, F)

    return tree_map_with_path(spec, params)


def param_shardings(params, cfg: ModelConfig, mesh):
    """Tree of :class:`MeshSharding` matching ``params``; ``mesh`` is a
    DeviceMesh."""
    specs = param_specs(params, cfg, mesh)
    return tree_map_with_path(lambda _, s: MeshSharding(mesh, spec_placements(mesh, s)), specs)
