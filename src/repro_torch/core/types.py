"""Core datatypes of the PyTorch port (counterpart of ``repro.core.types``).

The compressed representation is the paper's triple (B, R, E*): the
knowledge base ``B`` (sub-bases with quantized origins, spans and member
timestamps), the residual refinement pyramid ``R``, and the error
thresholds.  The base is host metadata (numpy arrays of timestamps); a
``ResidualStream``'s symbols are a torch tensor on the codec's device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .entropy import backend_name
from .errors import ConfigError

# Multiplier grid for the adaptive threshold (Eq. 4): beta is quantized to
# ``beta_levels`` levels so cone origins share grids and can merge.
DEFAULT_BETA_LEVELS = 16


@dataclasses.dataclass(frozen=True)
class ShrinkConfig:
    """Static configuration of the codec (E* of the paper, plus knobs).

    eps_b:        base (semantics-extraction) error threshold, absolute.
    lam:          lambda of the default interval length L = lam * n * eps_b.
    beta_levels:  number of discrete fluctuation levels.
    min_interval: lower clamp for L.
    max_interval: upper clamp for L.
    """

    eps_b: float
    lam: float = 1e-5
    beta_levels: int = DEFAULT_BETA_LEVELS
    min_interval: int = 2
    max_interval: int = 65536

    def __post_init__(self) -> None:
        if self.eps_b <= 0:
            raise ValueError(f"eps_b must be positive, got {self.eps_b}")
        if self.lam <= 0:
            raise ValueError(f"lam must be positive, got {self.lam}")
        if self.beta_levels < 1:
            raise ValueError("beta_levels must be >= 1")


@dataclasses.dataclass
class Segment:
    """One shrinking cone emitted by semantics extraction (Alg. 3).

    A one-point segment has the unbounded span (-inf, +inf).
    """

    theta: float
    level: int
    psi_lo: float
    psi_hi: float
    t0: int
    length: int


@dataclasses.dataclass
class SubBase:
    """A merged group of cones sharing an origin (Alg. 4) and its line."""

    theta: float
    level: int
    psi_lo: float
    psi_hi: float
    slope: float
    slope_digits: int
    t0s: np.ndarray  # int64 [m]
    lengths: np.ndarray  # int64 [m]


@dataclasses.dataclass
class Base:
    """The knowledge base B: all sub-bases + global stats needed to decode."""

    n: int
    config: ShrinkConfig
    vmin: float
    vmax: float
    subbases: list[SubBase]

    @property
    def k(self) -> int:
        return len(self.subbases)

    def segment_count(self) -> int:
        return int(sum(len(sb.t0s) for sb in self.subbases))

    def predictions(self) -> np.ndarray:
        """The base-only approximation of all n points as a float64 host
        array, as the reference computes it (``base_predictions`` gives the
        same values on a device)."""
        out = np.empty(self.n, dtype=np.float64)
        for sb in self.subbases:
            for t0, ln in zip(sb.t0s.tolist(), sb.lengths.tolist()):
                t = np.arange(ln, dtype=np.float64)
                out[t0 : t0 + ln] = sb.theta + sb.slope * t
        return out


@dataclasses.dataclass
class ResidualStream:
    """Quantized residuals of one pyramid tier.

    mode 'midpoint': dequant at r_lo + (q + 0.5) * step, |error| <= step/2.
    mode 'exact':    integer-domain lossless refinement at step 10^-decimals.
    """

    eps_r: float
    step: float
    r_lo: float
    mode: str  # 'midpoint' | 'exact'
    q: torch.Tensor  # int64 [n] on the codec's device


@dataclasses.dataclass
class PyramidLayer:
    """One refinement layer of a :class:`ResidualPyramid`.

    mode 'midpoint' | 'exact' | 'identity' (the prefix already meets this
    tier: no bytes).  ``corrupt`` marks a layer whose payload failed its
    CRC in a tolerant (``strict=False``) decode.
    """

    eps: float
    mode: str
    step: float
    r_lo: float
    payload: Optional[bytes]
    corrupt: bool = False

    def nbytes(self) -> int:
        return len(self.payload) if self.payload is not None else 0

    def backend(self) -> Optional[str]:
        """Entropy backend of this layer's payload (its leading tag byte),
        or None for identity and quarantined layers."""
        if self.payload is None or not len(self.payload):
            return None
        return backend_name(self.payload[0])


@dataclasses.dataclass
class ResidualPyramid:
    """Layered refinement pyramid: tiers coarse -> fine, eps strictly
    decreasing, an optional lossless (eps == 0.0) layer last."""

    layers: list[PyramidLayer]

    def tiers(self) -> list[float]:
        return [layer.eps for layer in self.layers]

    def resolve(self, eps: float, eps_b_practical: float) -> int:
        """Index of the cheapest layer prefix whose guarantee is <= ``eps``
        (-1 = the bare base suffices)."""
        if eps < 0.0:
            raise ConfigError(f"eps must be >= 0, got {eps}")
        if eps >= eps_b_practical:
            return -1
        for k, layer in enumerate(self.layers):
            if layer.eps <= eps:
                return k
        raise ConfigError(
            f"no tier with guarantee <= {eps!r}: archive tiers are "
            f"{self.tiers()} (base-only above {eps_b_practical!r})"
        )

    def prefix_nbytes(self, k: int) -> int:
        """Payload bytes needed to decode at layer k (-1 = base only)."""
        return sum(layer.nbytes() for layer in self.layers[: k + 1])

    def nbytes(self) -> int:
        return self.prefix_nbytes(len(self.layers) - 1)

    def backend_stats(self) -> dict[str, dict[str, int]]:
        """Per-backend ``{"streams": count, "bytes": payload bytes}``."""
        out: dict[str, dict[str, int]] = {}
        for layer in self.layers:
            b = layer.backend()
            if b is None:
                continue
            d = out.setdefault(b, {"streams": 0, "bytes": 0})
            d["streams"] += 1
            d["bytes"] += layer.nbytes()
        return out


@dataclasses.dataclass
class CompressedSeries:
    """A fully encoded series: one base + a residual refinement pyramid."""

    base: Base
    base_bytes: bytes
    pyramid: ResidualPyramid
    # max |v - base prediction|: eps above it is served base-only
    eps_b_practical: float

    def tiers(self) -> list[float]:
        return self.pyramid.tiers()

    def size_at(self, eps: float) -> int:
        """Bytes needed to decode at resolution ``eps``: the base and the
        cheapest sufficient layer prefix (the paper's compression ratio)."""
        k = self.pyramid.resolve(eps, self.eps_b_practical)
        return len(self.base_bytes) + self.pyramid.prefix_nbytes(k)

    def total_nbytes(self) -> int:
        return len(self.base_bytes) + self.pyramid.nbytes()

    def backend_stats(self) -> dict[str, dict[str, int]]:
        """Per-backend stream/byte counts of this series' residual layers."""
        return self.pyramid.backend_stats()


@dataclasses.dataclass(frozen=True)
class FrameMeta:
    """Directory entry of one frame of a ``SHRKS`` framed container: the
    samples [t_lo, t_hi) of one series, whose ``SHRK`` payload lies at
    [offset, offset + length) of the container; ``kb_epoch`` is the shared
    knowledge base's entry count when the frame sealed."""

    series_id: int
    t_lo: int
    t_hi: int
    kb_epoch: int
    offset: int
    length: int
    crc32: int


def merge_backend_stats(
    acc: dict[str, dict[str, int]], more: dict[str, dict[str, int]]
) -> dict[str, dict[str, int]]:
    """Accumulate one ``backend_stats()`` result into ``acc`` (in place and
    returned)."""
    for b, d in more.items():
        a = acc.setdefault(b, {"streams": 0, "bytes": 0})
        a["streams"] += d["streams"]
        a["bytes"] += d["bytes"]
    return acc
