"""The general traffic generator: every mix is a JSON file of parameters
(``traffic/<mix>.json``) that these functions read.

Lengths are a fixed multiset taken from the quantiles of the mix's
distribution, the same for every seed; the seed only orders them (a new
shuffle each sweep) and draws the data (token ids, cache values).  So two
seeds do the same work in another order.
"""
from __future__ import annotations

import random
import statistics

import torch

from .common import derive_seed

_NORMAL = statistics.NormalDist()


def lengths(spec: dict) -> list[int]:
    """The multiset of lengths of ``spec``: ``dist`` "lognormal" with its
    ``median`` and ``sigma``, clipped to [``min``, ``max``], at the midpoints
    of ``count`` equal quantile bins; or, with ``total_tokens`` in place of
    ``count``, the fewest bins whose lengths add up to at least that."""
    if spec["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")

    def at(n: int) -> list[int]:
        out = []
        for i in range(n):
            z = _NORMAL.inv_cdf((i + 0.5) / n)
            x = spec["median"] * 2.718281828459045 ** (spec["sigma"] * z)
            out.append(int(min(max(round(x), spec["min"]), spec["max"])))
        return out

    if "count" in spec:
        return at(int(spec["count"]))
    total, n = int(spec["total_tokens"]), 1
    while sum(at(n)) < total:
        n += 1
    return at(n)


class Schedule:
    """Items of a fixed multiset in seeded sweeps: each item once a sweep,
    each sweep in a new order.  ``next()`` gives (request number, item)."""

    def __init__(self, n: int, seed: int):
        self.n, self.seed = n, seed
        self.count = 0
        self._order: list[int] = []

    def next(self) -> tuple[int, int]:
        if not self._order:  # a new sweep: its order, reversed for pop()
            self._order = list(range(self.n))
            random.Random(derive_seed(self.seed, "order", self.count // self.n)).shuffle(
                self._order)
            self._order.reverse()
        k = self.count
        self.count += 1
        return k, self._order.pop()


def prompt_tokens(seed: int, request: int, length: int, vocab: int, device) -> torch.Tensor:
    """Token ids [1, length] int32 of request number ``request``, uniform
    over the vocabulary, drawn on ``device``."""
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, "tokens", request))
    return torch.randint(0, vocab, (1, length), generator=gen, device=device, dtype=torch.int32)


def kv_cache(seed: int, session: int, length: int, layers: int, kv_heads: int, head_dim: int,
             spec: dict, device) -> tuple[torch.Tensor, torch.Tensor]:
    """One session's cache of ``length`` positions in the port's stacked
    layout: K and V [layers, 1, length, kv_heads, head_dim] bf16, normal
    values with a log-normal scale per (kv head, channel), K's channels
    spread wider (``k_spread``) than V's (``v_spread``), some large as in
    real K caches."""
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, "kv", session))
    out = []
    for spread in (spec["k_spread"], spec["v_spread"]):
        scale = torch.exp(torch.randn((kv_heads, head_dim), generator=gen, device=device) * spread)
        x = torch.randn((layers, 1, length, kv_heads, head_dim), generator=gen, device=device,
                        dtype=torch.bfloat16)
        out.append(x.mul_(scale.to(torch.bfloat16)))
    return out[0], out[1]
