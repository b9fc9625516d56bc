"""Deterministic sharded data pipeline, counterpart of
``repro.data.pipeline``.

* ``TokenPipeline``: synthetic LM token streams keyed by (step, shard), a
  pure function of the step index (deterministic resume and elastic
  restarts).  numpy, the reference's draws: equal arrays for equal seeds.
* ``ShardStore``: SHRINK-compressed series shards on disk, each chunk
  compressed once by the ported ``ShrinkCodec`` on ``device`` (the card
  unless ``device="cpu"``), random access by (name, chunk).  The chunk
  files are the reference's bytes, and reads return float64 numpy arrays
  as the reference's do.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..core import entropy
from ..core.device import resolve_device
from ..core.shrink import ShrinkCodec, cs_from_bytes, cs_to_bytes

__all__ = ["TokenPipeline", "ShardStore"]


def _store_backend() -> str:
    """zstd when the optional extra is installed (the historical choice for
    bulk stores), the rANS engine otherwise; never 'best', which would add
    the pure-python range coder to every encode just to compare sizes."""
    return "zstd" if "zstd" in entropy.available_backends() else "rans"


@dataclasses.dataclass
class TokenPipeline:
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0
    n_shards: int = 16  # over-decomposition factor for straggler re-dispatch

    def _shard_tokens(self, step: int, shard: int, rows: int) -> np.ndarray:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + shard
        )
        # Zipf-ish unigram + repetition: learnable bigram structure
        base = rng.zipf(1.3, size=(rows, self.seq_len)).astype(np.int64)
        tokens = np.clip(base, 1, self.vocab_size - 1)
        rep = rng.random((rows, self.seq_len)) < 0.3
        tokens[:, 1:] = np.where(rep[:, 1:], tokens[:, :-1], tokens[:, 1:])
        return tokens.astype(np.int32)

    def batch_at(self, step: int) -> dict:
        """Global batch for `step` (numpy int32 tokens and labels [B, S]),
        a pure function of step."""
        rows_per_shard = max(1, self.batch // self.n_shards)
        shards = [
            self._shard_tokens(step, s, rows_per_shard)
            for s in range(self.n_shards)
        ]
        tokens = np.concatenate(shards, axis=0)[: self.batch]
        if tokens.shape[0] < self.batch:  # n_shards > batch
            reps = -(-self.batch // tokens.shape[0])
            tokens = np.tile(tokens, (reps, 1))[: self.batch]
        labels = np.roll(tokens, -1, axis=1)
        return {"tokens": tokens, "labels": labels}


class ShardStore:
    """SHRINK-compressed chunked series store with random access.

    put(name, values, eps_list, decimals) chunks the series and compresses
    each chunk independently; get(name, eps) decompresses each chunk (one
    chunk alone with get_chunk)."""

    def __init__(self, directory: str | Path, chunk: int = 65_536,
                 device: torch.device | str | None = None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.chunk = chunk
        self.device = resolve_device(device)

    def put(
        self,
        name: str,
        values: np.ndarray,
        eps_list: list[float],
        decimals: Optional[int] = None,
        frac: float = 0.05,
    ) -> dict:
        values = np.asarray(values, dtype=np.float64)
        d = self.dir / name
        d.mkdir(parents=True, exist_ok=True)
        n_chunks = -(-len(values) // self.chunk)
        total = 0
        for c in range(n_chunks):
            seg = values[c * self.chunk : (c + 1) * self.chunk]
            codec = ShrinkCodec.from_fraction(seg, frac=frac, backend=_store_backend(),
                                              device=self.device)
            cs = codec.compress(seg, eps_targets=eps_list, decimals=decimals)
            blob = cs_to_bytes(cs)
            (d / f"chunk_{c}.shrk").write_bytes(blob)
            total += len(blob)
        meta = {
            "n": int(len(values)),
            "chunk": self.chunk,
            "n_chunks": n_chunks,
            "eps_list": eps_list,
            "decimals": decimals,
            "bytes": total,
        }
        (d / "meta.json").write_text(json.dumps(meta))
        return meta

    def meta(self, name: str) -> dict:
        return json.loads((self.dir / name / "meta.json").read_text())

    def get_chunk(self, name: str, eps: float, chunk_idx: int) -> np.ndarray:
        blob = (self.dir / name / f"chunk_{chunk_idx}.shrk").read_bytes()
        cs = cs_from_bytes(blob)
        codec = ShrinkCodec.from_fraction(np.zeros(2), frac=0.05, device=self.device)
        return codec.decompress_at(cs, eps).cpu().numpy()

    def get(self, name: str, eps: float) -> np.ndarray:
        m = self.meta(name)
        parts = [self.get_chunk(name, eps, c) for c in range(m["n_chunks"])]
        return np.concatenate(parts)[: m["n"]]
