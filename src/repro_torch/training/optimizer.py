"""AdamW on trees of tensors, counterpart of ``repro.training.optimizer``
(no ``torch.optim``): the state mirrors the params with float32 first and
second moments and an int32 step, and each update is computed in float32
and cast back to the param's dtype (bf16 params keep float32 moments).

The arithmetic is the reference's op by op, in its order: on the CPU an
update of identical inputs equals the reference's bit for bit except where
``b ** step`` and ``cos`` round another way (an ulp of the schedule and
the bias corrections, ``tests/test_torch_optimizer.py``).  Scalars that
divide are float32 tensors: CUDA torch turns a division by a Python float
into a multiply by its reciprocal.  On a mesh the state mirrors the
params' placements (``adamw_init`` of DTensors gives DTensors of local
zeros), and the sharded train step updates each rank's pieces.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.distributed.tensor import DTensor

from ._tree import leaves, tree_map, unflatten

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "clip_by_global_norm", "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    # cosine decay horizon; 0 = constant after warmup
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _zeros(p: torch.Tensor) -> torch.Tensor:
    """float32 zeros of ``p``'s shape; of its placements, each rank's piece
    zeros, where ``p`` is a DTensor (a sharded step's param)."""
    if isinstance(p, DTensor):
        local = p.to_local()
        local = torch.zeros(local.shape, dtype=torch.float32, device=local.device)
        return DTensor.from_local(local, p.device_mesh, p.placements, run_check=False,
                                  shape=p.shape, stride=p.stride())
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def adamw_init(params) -> dict:
    zeros = _zeros
    flat = [p.to_local() if isinstance(p, DTensor) else p for p in leaves(params)]
    dev = flat[0].device if flat else None
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    s = step.to(torch.float32)
    warm = torch.clamp_max(torch.div(s + 1, _f32(max(cfg.warmup_steps, 1), s)), 1.0)
    if cfg.decay_steps > 0:
        t = torch.clamp(torch.div(s - cfg.warmup_steps, _f32(max(cfg.decay_steps, 1), s)),
                        0.0, 1.0)
        cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    else:
        cos = 1.0
    return cfg.lr * warm * cos


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32))) for g in leaves(tree)))


def clip_by_global_norm(grads, max_norm: float, norm=None):
    """``grads`` scaled to a global norm of at most ``max_norm``, and the
    norm.  ``norm``: the norm where the caller has it (a sharded step sums
    its pieces over the mesh), else :func:`global_norm`'s."""
    norm = global_norm(grads) if norm is None else norm
    scale = torch.clamp_max(torch.div(_f32(max_norm, norm), torch.clamp_min(norm, 1e-9)), 1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype), grads), norm


def adamw_update(cfg: AdamWConfig, params, grads, state):
    step = state["step"] + 1
    lr = _schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    sf = step.to(torch.float32)
    bc1 = 1 - torch.pow(_f32(b1, sf), sf)
    bc2 = 1 - torch.pow(_f32(b2, sf), sf)

    def upd(p, g, m, v):
        gf = g.to(torch.float32)
        m = b1 * m + (1 - b1) * gf
        v = b2 * v + (1 - b2) * gf * gf
        mhat = m / bc1
        vhat = v / bc2
        pf = p.to(torch.float32)
        new_p = pf - lr * (mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * pf)
        return new_p.to(p.dtype), m, v

    out = [upd(p, g, m, v) for p, g, m, v in zip(leaves(params), leaves(grads),
                                                 leaves(state["m"]), leaves(state["v"]))]
    return unflatten(params, [o[0] for o in out]), {
        "m": unflatten(params, [o[1] for o in out]),
        "v": unflatten(params, [o[2] for o in out]),
        "step": step,
    }
