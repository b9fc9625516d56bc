"""What the per-layer readers share: device time of the kernels whose
names match a metric's patterns, in a traced run."""
from __future__ import annotations

import re


def kernel_seconds(trace, patterns, exclude=()) -> float:
    """Device seconds of the traced kernels whose names match any of
    ``patterns`` and none of ``exclude`` (0.0 where none ran)."""
    if trace is None:
        return 0.0
    inc = re.compile("|".join(patterns))
    exc = re.compile("|".join(exclude)) if exclude else None
    return sum(sec for name, (sec, _) in trace.device_ops.items()
               if inc.search(name) and not (exc and exc.search(name)))


def share(bound_s: float, took_s: float):
    """100 x bound / time, or None where nothing was measured."""
    if took_s <= 0.0 or bound_s <= 0.0:
        return None
    return 100.0 * bound_s / took_s


def idle_percent(trace):
    """The share of the traced window in which no operation ran on the card."""
    if trace is None or trace.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
