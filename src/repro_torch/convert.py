"""Carry state from the reference package into the port.

Both take plain data, never a ``repro`` object, so this module imports
nothing of ``repro``:

* :func:`config_from_reference` takes ``dataclasses.asdict`` of a
  ``repro.core.ShrinkConfig``;
* :func:`series_from_reference` takes the ``SHRK`` bytes of a reference
  ``CompressedSeries`` (``repro.core.cs_to_bytes``).
"""
from __future__ import annotations

import dataclasses

from .core.shrink import cs_from_bytes
from .core.types import CompressedSeries, ShrinkConfig

__all__ = ["config_from_reference", "series_from_reference"]


def config_from_reference(fields: dict) -> ShrinkConfig:
    """A port config with the same fields as the reference config."""
    names = {f.name for f in dataclasses.fields(ShrinkConfig)}
    unknown = set(fields) - names
    if unknown:
        raise ValueError(f"unknown ShrinkConfig fields {sorted(unknown)}")
    return ShrinkConfig(**fields)


def series_from_reference(blob: bytes) -> CompressedSeries:
    """The port's view of a reference ``SHRK`` blob (same base, pyramid and
    payload bytes)."""
    return cs_from_bytes(blob)
