"""SHRINK-compressed metrics logger, counterpart of
``repro.training.metrics``: scalars buffered per key and flushed as
SHRINK chunks (lossless at a fixed decimal precision, plus a dashboard
tier) through the ``ShardStore`` on ``device`` (the card unless
``device="cpu"``); the files are the reference's bytes."""
from __future__ import annotations

from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from ..data.pipeline import ShardStore

__all__ = ["MetricsLogger"]


class MetricsLogger:
    def __init__(self, directory: str | Path, decimals: int = 6,
                 dashboard_eps: float = 1e-2, chunk: int = 4096,
                 device: torch.device | str | None = None):
        self.store = ShardStore(directory, chunk=chunk, device=device)
        self.decimals = decimals
        self.dashboard_eps = dashboard_eps
        self.buffers: dict[str, list[float]] = defaultdict(list)
        self.flushed: dict[str, int] = defaultdict(int)

    def log(self, step: int, metrics: dict) -> None:
        for k, v in metrics.items():
            self.buffers[k].append(float(v))

    def flush(self) -> dict:
        """Compress every buffered series; returns {key: stored_bytes}."""
        out = {}
        for k, vals in self.buffers.items():
            if not vals:
                continue
            v = np.round(np.asarray(vals, dtype=np.float64), self.decimals)
            rng = float(v.max() - v.min()) or 1.0
            meta = self.store.put(
                f"{k}_{self.flushed[k]}", v,
                eps_list=[self.dashboard_eps * rng, 0.0],
                decimals=self.decimals,
            )
            out[k] = meta["bytes"]
            self.flushed[k] += 1
            self.buffers[k] = []
        return out

    def read(self, key: str, lossless: bool = True) -> np.ndarray:
        """Concatenate all flushed chunks for `key`."""
        parts = []
        for i in range(self.flushed[key]):
            name = f"{key}_{i}"
            meta = self.store.meta(name)
            eps = 0.0 if lossless else meta["eps_list"][0]
            parts.append(self.store.get(name, eps))
        return np.concatenate(parts) if parts else np.zeros(0)
