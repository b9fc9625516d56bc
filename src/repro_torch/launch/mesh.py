"""Mesh construction for the port, counterpart of ``repro.launch.mesh``.

Single pod:  (16, 16)      axes ("data", "model")        = 256 ranks
Multi-pod:   (2, 16, 16)   axes ("pod", "data", "model") = 512 ranks

One rank a card, under ``torchrun`` (which sets the world size and the
rendezvous in the environment); ``init_device_mesh`` creates the default
process group when none exists.  Functions, so importing this module
touches no device and no process group.
"""
from __future__ import annotations

import os

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..core.errors import ConfigError

__all__ = ["make_production_mesh", "make_local_mesh", "HW"]


def _world_size() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need, world = shape[0] * shape[1] * (shape[2] if multi_pod else 1), _world_size()
    if world != need:
        raise ConfigError(f"the production mesh {dict(zip(axes, shape))} needs a world of "
                          f"{need} ranks (one a card, under torchrun); this world has {world}")
    return init_device_mesh("cuda", shape, mesh_dim_names=axes)


def make_local_mesh(data: int = 1, model: int = 1, device_type: str = "cuda"):
    """A ("data", "model") mesh over the world's ranks (tests: a one-rank
    gloo group and ``device_type="cpu"``)."""
    return init_device_mesh(device_type, (data, model), mesh_dim_names=("data", "model"))


class HW:
    """NVIDIA H100 80GB HBM3 (SXM), 700 W, per card: the published dense
    peaks of NVIDIA's H100 data sheet, which the roofline bounds in
    ``PERF.md`` divide by.  NVLink 4: 18 links, 900 GB/s a card in both
    directions together, so 50 GB/s a link."""

    PEAK_BF16_FLOPS = 989e12  # FLOP/s, dense
    HBM_BW = 3.35e12  # B/s
    ICI_BW = 50e9  # B/s a NVLink link, both directions
    HBM_BYTES = 80 * 1024**3  # five 16 GiB HBM3 stacks
