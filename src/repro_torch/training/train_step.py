"""Train and serve steps, counterpart of ``repro.training.train_step``.

* ``make_train_step``: the loss's gradient on the params, clipped by the
  global norm, then AdamW.  ``mesh`` None: one device.  A DeviceMesh:
  data parallelism over its batch axes (``("pod", "data")``, as the
  reference's rules map ``batch``): each rank takes its slice of dim 0 of
  the global batch, and one ``all_reduce`` over the ranks that share a
  ``"model"`` coordinate averages the gradients and the metrics, all
  leaves flattened into one float32 buffer in a fixed order; clip and
  AdamW then run the same on every rank.  Params and optimizer state stay
  whole on every rank; ranks along ``"model"`` compute the same step (the
  port's layers take no GSPMD hints, ``parallel.sharding``).  A state
  placed on a mesh (DTensor leaves, as ``load_checkpoint`` restores
  through ``param_shardings``) is made whole on every rank when the step
  starts, so training resumes from it.
* ``make_compressed_train_step``: each pod takes its slice of the global
  batch, computes its gradient, and the cross-pod mean rides the SHRINK
  compressed exchange (``grad_compress.py``) with error feedback carried in
  the step state.  ``mesh`` is a ``torch.distributed.device_mesh.DeviceMesh``
  with a ``"pod"`` dimension, whose process group carries the collectives.
* ``make_prefill_step`` / ``make_decode_step`` run under the mesh's rules
  (decode with ``seq_model`` on ``"model"``); under them an MoE config
  with ``moe_ep`` takes the expert-parallel route.

A step takes params as a tree of tensors and returns new trees (the
reference's ``(params, opt_state, metrics)``); the gradient is autograd's
on fresh leaves that require grad, so the caller's tensors never carry a
graph.  Metrics are 0-d float32 tensors: ``loss``, ``grad_norm``, ``xent``,
``z_loss`` and ``moe_aux``.  ``batch_specs``, ``cache_specs`` and
``train_state_specs`` are the reference's spec maps (``parallel.sharding.P``
trees).
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..configs.base import ModelConfig
from ..core.errors import ConfigError
from ..models import Model
from ..parallel.partition import param_specs
from ..parallel.sharding import P, axis_rules, make_rules, mesh_axes, tree_map_with_path
from ._tree import leaves, tree_map, unflatten
from .grad_compress import GradCompressConfig, _concat, _split, compressed_psum_tree
from .optimizer import AdamWConfig, adamw_update, clip_by_global_norm

__all__ = [
    "batch_specs",
    "cache_specs",
    "make_compressed_train_step",
    "make_decode_step",
    "make_ef_state",
    "make_prefill_step",
    "make_train_step",
    "train_state_specs",
]


# ---------------------------------------------------------------- spec maps
def _axes_size(mesh, batch_axes) -> int:
    shape = mesh_axes(mesh)
    return math.prod(shape[a] for a in (batch_axes if isinstance(batch_axes, tuple)
                                        else (batch_axes,)))


def batch_specs(batch_tree, mesh, batch_axes) -> Any:
    """Shard dim0 of every batch leaf over the batch axes (if divisible)."""
    size = _axes_size(mesh, batch_axes)

    def spec(leaf):
        b = leaf.shape[0] if leaf.ndim else 0
        if leaf.ndim == 0 or b % size:
            return P()
        return P(batch_axes, *([None] * (leaf.ndim - 1)))

    return tree_map(spec, batch_tree)


def cache_specs(cache_tree, mesh, batch_axes, seq_axis: str = "model") -> Any:
    """KV caches: batch over the data axes, the cache's sequence over the
    model axis (the flash-decoding layout: a card's cache memory is S/16,
    always divisible, unlike kv-head counts).  Recurrent states split their
    width or head dims over model."""
    bsz = _axes_size(mesh, batch_axes)
    msz = mesh_axes(mesh).get("model", 1)
    if isinstance(batch_axes, tuple) and len(batch_axes) == 1:
        batch_axes = batch_axes[0]

    def spec(path, leaf):
        name = next((k for k in reversed(path) if isinstance(k, str)), None)
        batch = batch_axes if (leaf.ndim and leaf.shape[0] % bsz == 0) else None
        b2 = batch_axes if (leaf.ndim > 1 and leaf.shape[1] % bsz == 0) else None

        def seq_ok(dim_size):
            return seq_axis if dim_size % msz == 0 else None

        def model_ok(dim_size):
            return "model" if dim_size % msz == 0 else None

        nd, sh = leaf.ndim, leaf.shape
        if name in ("k", "v") and nd == 4:  # [B, S, KV, D]
            return P(batch, seq_ok(sh[1]), None, None)
        if name in ("k", "v") and nd == 5:  # stacked [G, B, S, KV, D]
            return P(None, b2, seq_ok(sh[2]), None, None)
        if name == "kpos" and nd == 2:
            return P(batch, seq_ok(sh[1]))
        if name == "kpos" and nd == 3:
            return P(None, b2, seq_ok(sh[2]))
        if name in ("c_kv", "k_rope") and nd == 3:  # [B, S, R]
            return P(batch, seq_ok(sh[1]), None)
        if name in ("c_kv", "k_rope") and nd == 4:
            return P(None, b2, seq_ok(sh[2]), None)
        if name == "wkv" and nd == 4:  # [B, H, K, V]
            return P(batch, model_ok(sh[1]), None, None)
        if name == "wkv" and nd == 5:
            return P(None, b2, model_ok(sh[2]), None, None)
        if name == "h" and nd == 2:
            return P(batch, model_ok(sh[1]))
        if name == "h" and nd == 3:
            return P(None, b2, model_ok(sh[2]))
        if name == "conv" and nd == 3:
            return P(batch, None, model_ok(sh[2]))
        if name == "conv" and nd == 4:
            return P(None, b2, None, model_ok(sh[3]))
        if name in ("shift_t", "shift_c") and nd == 2:
            return P(batch, None)
        if name in ("shift_t", "shift_c") and nd == 3:
            return P(None, b2, None)
        return P(*([None] * nd))

    return tree_map_with_path(spec, cache_tree)


def train_state_specs(params_shapes, cfg: ModelConfig, mesh):
    ps = param_specs(params_shapes, cfg, mesh)
    return {
        "m": ps,
        "v": ps,
        "step": P(),
    }


# ------------------------------------------------------------- train steps
def _value_and_grad(model: Model, params, batch):
    """(loss, parts, grads): the gradient of ``model.loss`` on every param
    (zeros where the loss does not read one)."""
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, parts = model.loss(p, batch)
        flat = leaves(p)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(flat, grads)]
    return loss.detach(), {k: v.detach() for k, v in parts.items()}, unflatten(params, grads)


def _update(opt_cfg: AdamWConfig, params, opt_state, grads):
    with torch.no_grad():
        grads, gnorm = clip_by_global_norm(grads, opt_cfg.grad_clip)
        params, opt_state = adamw_update(opt_cfg, params, grads, opt_state)
    return params, opt_state, gnorm


def _whole(tree):
    """``tree`` with each DTensor leaf gathered whole onto every rank."""
    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor) else t, tree)


class _DataParallel:
    """The batch axes of a DeviceMesh: this rank's index among the ranks
    that share its ``"model"`` coordinate (pod major), their count, and
    their process group (the axis's own group, or one made for the pod x
    data plane: every rank makes every plane's group, in one order)."""

    def __init__(self, mesh):
        axes = mesh_axes(mesh)
        names = [a for a in ("pod", "data") if a in axes]
        if not names:
            raise ConfigError(f"data parallelism needs a 'data' or 'pod' axis; the mesh has "
                              f"{tuple(axes)}")
        coord = dict(zip(axes, mesh.get_coordinate()))
        self.n = math.prod(axes[a] for a in names)
        self.rank = 0
        for a in names:
            self.rank = self.rank * axes[a] + coord[a]
        if len(names) == 1:
            self.group = mesh.get_group(names[0])
        else:
            ranks = mesh.mesh.permute(*[list(axes).index(a) for a in names]
                                      + [i for i, a in enumerate(axes) if a not in names])
            planes = ranks.reshape(self.n, -1).T.tolist()
            mine = dist.get_rank()
            for plane in planes:  # every rank creates every group
                group = dist.new_group(plane)
                if mine in plane:
                    self.group = group

    def slice(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a batch leaf (the whole leaf where dim 0 does
        not divide, as ``batch_specs`` replicates it)."""
        if x.ndim == 0 or x.shape[0] % self.n:
            return x
        b = x.shape[0] // self.n
        return x[self.rank * b:(self.rank + 1) * b]

    def mean(self, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
        """The ranks' mean of each tensor: one all_reduce of one float32
        buffer holding them all, in order."""
        buf, shapes = _concat(tensors)
        dist.all_reduce(buf, group=self.group)
        buf = torch.div(buf, torch.tensor(float(self.n), device=buf.device))
        return [m.to(t.dtype) for m, t in zip(_split(buf, tensors, shapes), tensors)]


def make_train_step(model: Model, mesh=None, opt_cfg: AdamWConfig = AdamWConfig()):
    rules = None if mesh is None else make_rules(mesh, model.cfg)
    dp = None if mesh is None else _DataParallel(mesh)
    if dp is not None and model.cfg.moe_ep and mesh_axes(mesh).get("model", 1) > 1:
        raise ConfigError("the data-parallel step keeps every expert on each rank; expert "
                          "parallelism (moe_ep over a model axis) runs in prefill and decode")

    def step(params, opt_state, batch):
        params, opt_state = _whole(params), _whole(opt_state)
        if dp is not None:
            batch = {k: dp.slice(v) for k, v in batch.items()}
        with axis_rules(rules):
            loss, parts, grads = _value_and_grad(model, params, batch)
        metrics = {"loss": loss, **parts}
        if dp is not None:
            flat = leaves(grads)
            got = dp.mean(flat + list(metrics.values()))
            grads = unflatten(grads, got[:len(flat)])
            metrics = dict(zip(metrics, got[len(flat):]))
        params, opt_state, gnorm = _update(opt_cfg, params, opt_state, grads)
        metrics = {"loss": metrics.pop("loss"), "grad_norm": gnorm, **metrics}
        return params, opt_state, metrics

    return step


def make_compressed_train_step(
    model: Model,
    mesh,
    opt_cfg: AdamWConfig = AdamWConfig(),
    comp_cfg: GradCompressConfig = GradCompressConfig(),
):
    """Cross-pod SHRINK-compressed data parallelism: ``step(params,
    opt_state, ef, batch)`` with the global batch; this pod trains on its
    slice of dim 0 (the reference's ``P("pod")`` in-spec)."""
    cfg = model.cfg
    if comp_cfg.axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"compressed step needs a {comp_cfg.axis!r} axis")
    if cfg.dcn_fsdp:
        raise ValueError("compressed collective targets pod-replicated params")
    group = mesh.get_group(comp_cfg.axis)
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)

    def pod_slice(x):
        b = x.shape[0] // n
        return x[rank * b:(rank + 1) * b]

    def step(params, opt_state, ef, batch):
        local = {k: pod_slice(v) for k, v in batch.items()}
        loss, parts, grads = _value_and_grad(model, params, local)
        grads, ef = compressed_psum_tree(grads, ef, comp_cfg, group=group)
        params, opt_state, gnorm = _update(opt_cfg, params, opt_state, grads)
        # every metric is the pods' mean, as the reference's psum / n
        metrics = {"loss": loss, "grad_norm": gnorm, **parts}
        vals = torch.stack([metrics[k].to(torch.float32) for k in metrics])
        if n > 1:
            dist.all_reduce(vals, group=group)
        vals = torch.div(vals, torch.tensor(float(n), device=vals.device))
        return params, opt_state, ef, dict(zip(metrics, vals.unbind()))

    return step


def make_ef_state(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


# ------------------------------------------------------------- serve steps
def make_prefill_step(model: Model, mesh=None):
    rules = None if mesh is None else make_rules(mesh, model.cfg)

    def step(params, batch):
        with axis_rules(rules):
            return model.prefill(params, batch)

    return step


def make_decode_step(model: Model, mesh=None):
    # seq_model: decode attention runs against sequence-sharded caches
    rules = None if mesh is None else make_rules(mesh, model.cfg,
                                                 overrides={"seq_model": "model"})

    def step(params, tokens, caches, cache_index):
        with axis_rules(rules):
            return model.decode_step(params, tokens, caches, cache_index)

    return step
