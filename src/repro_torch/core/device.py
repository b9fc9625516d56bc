"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: ``None``
means ``cuda``.  A request for CUDA on a machine without it raises; the
port never moves to the CPU on its own.
"""
from __future__ import annotations

import torch

from .errors import ConfigError

__all__ = ["resolve_device"]


def resolve_device(device: torch.device | str | None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise ConfigError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain torch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ConfigError(f"unsupported device {dev} (cuda or cpu)")
    return dev
