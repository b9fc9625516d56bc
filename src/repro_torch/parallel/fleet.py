"""Fleet partitioning, counterpart of ``repro.parallel.fleet``: the
series->shard placement of the serving fleet over the process' devices.

The serving fleet (``repro_torch.serving.fleet``) is data-parallel: each
shard owns a disjoint set of series end to end (ingest batcher,
container, gateway, analytics engine), so the only cross-shard traffic is
the knowledge-base sync.  This module holds the placement:

* :func:`shard_of` — the stable series->shard hash (splitmix64
  finalizer), identical to the reference's.
* :class:`FleetPlan` — the frozen topology: shard count, the devices of
  the fleet's data axis (``mesh``), the shard->device placement and the
  assignment in force.
* :func:`plan_fleet` — build a plan; ``assignment`` overrides the hash
  with an explicit ``{series_id: shard}`` map (unknown ids take the hash)
  or any callable.

The devices are the torch devices of the requested type: every CUDA card
of the process (default), or the CPU when asked.  Shards go round-robin
over them, so on one card every shard runs on ``cuda:0``, one after
another on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional, Union

import torch

from ..core.device import resolve_device

__all__ = ["FleetPlan", "plan_fleet", "shard_of"]

_MASK64 = (1 << 64) - 1


def shard_of(series_id: int, n_shards: int) -> int:
    """Deterministic, stable series->shard hash (splitmix64 finalizer):
    uniform over shards and identical on every node that routes."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    x = (int(series_id) * 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) % n_shards


@dataclasses.dataclass(frozen=True)
class FleetPlan:
    """Frozen fleet topology: who routes where, on which device."""

    n_shards: int
    mesh: tuple  # the torch devices of the fleet's "data" axis
    devices: tuple  # shard i runs on devices[i]
    assign: Callable[[int], int]  # series_id -> shard

    def shard_of(self, series_id: int) -> int:
        s = int(self.assign(int(series_id)))
        if not 0 <= s < self.n_shards:
            raise ValueError(
                f"assignment sent series {series_id} to shard {s} "
                f"outside [0, {self.n_shards})"
            )
        return s

    def device_of(self, shard: int) -> torch.device:
        return self.devices[shard]

    def describe(self) -> dict:
        return {
            "n_shards": self.n_shards,
            "mesh_devices": len(self.mesh),
            "devices": [str(d) for d in self.devices],
        }


def plan_fleet(
    n_shards: int,
    assignment: Optional[Union[Mapping[int, int], Callable[[int], int]]] = None,
    device: torch.device | str | None = None,
) -> FleetPlan:
    """Build the fleet topology: the data axis spans the devices of
    ``device``'s type (default the card: every CUDA device of the process;
    ``"cpu"``: the CPU), shards are placed round-robin over them, and
    series go to shards by ``assignment`` (default :func:`shard_of`; a
    mapping overrides specific ids and takes the hash for the rest)."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        avail = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        avail = [torch.device("cpu")]
    mesh = tuple(avail[: min(n_shards, len(avail))])
    devices = tuple(mesh[i % len(mesh)] for i in range(n_shards))
    if assignment is None:
        assign = lambda sid: shard_of(sid, n_shards)  # noqa: E731
    elif callable(assignment):
        assign = assignment
    else:
        table = {int(k): int(v) for k, v in assignment.items()}
        assign = lambda sid: table.get(sid, shard_of(sid, n_shards))  # noqa: E731
    return FleetPlan(n_shards=n_shards, mesh=mesh, devices=devices, assign=assign)
