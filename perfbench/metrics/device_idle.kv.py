"""The share of the traced window in which no operation ran on the card:
100 x (1 - busy / window), busy the union over time of the device's
kernel, memcpy and memset intervals inside the window."""
from harness.readers import idle_percent


def read(view):
    return None if view is None else idle_percent(view.trace)
