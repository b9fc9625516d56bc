"""Train and serve steps, counterpart of ``repro.training.train_step``.

* ``make_train_step``: the loss's gradient on the params, clipped by the
  global norm, then AdamW.  One device (``mesh`` None or a mesh of one
  device): data parallelism over a mesh comes with the mesh port (ROADMAP
  queue 1 item 5).
* ``make_compressed_train_step``: each pod takes its slice of the global
  batch, computes its gradient, and the cross-pod mean rides the SHRINK
  compressed exchange (``grad_compress.py``) with error feedback carried in
  the step state.  ``mesh`` is a ``torch.distributed.device_mesh.DeviceMesh``
  with a ``"pod"`` dimension, whose process group carries the collectives.

A step takes params as a tree of tensors and returns new trees (the
reference's ``(params, opt_state, metrics)``); the gradient is autograd's
on fresh leaves that require grad, so the caller's tensors never carry a
graph.  Metrics are 0-d float32 tensors: ``loss``, ``grad_norm``, ``xent``,
``z_loss`` and ``moe_aux``.  The reference's GSPMD spec maps
(``batch_specs``, ``cache_specs``, ``train_state_specs``) come with the mesh
port (item 5).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..models import Model
from ._tree import leaves, tree_map, unflatten
from .grad_compress import GradCompressConfig, compressed_psum_tree
from .optimizer import AdamWConfig, adamw_update, clip_by_global_norm

__all__ = [
    "make_compressed_train_step",
    "make_decode_step",
    "make_ef_state",
    "make_prefill_step",
    "make_train_step",
]


def _single_device(mesh) -> None:
    if mesh is not None and mesh.size() > 1:
        raise NotImplementedError("make_train_step runs on one device; data parallelism over a "
                                  "mesh is ROADMAP queue 1 item 5")


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


def make_train_step(model: Model, mesh=None, opt_cfg: AdamWConfig = AdamWConfig()):
    _single_device(mesh)

    def step(params, opt_state, batch):
        loss, parts, grads = _value_and_grad(model, params, batch)
        params, opt_state, gnorm = _update(opt_cfg, params, opt_state, grads)
        metrics = {"loss": loss, "grad_norm": gnorm, **parts}
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
    _single_device(mesh)

    def step(params, batch):
        return model.prefill(params, batch)

    return step


def make_decode_step(model: Model, mesh=None):
    _single_device(mesh)

    def step(params, tokens, caches, cache_index):
        return model.decode_step(params, tokens, caches, cache_index)

    return step
