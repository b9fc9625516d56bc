"""The traced run: ``torch.profiler`` over the measured window, reduced to
device busy time, device time by kernel name, and the longest idle gaps by
what the host was doing.

``busy_union`` is ``chip_smoke.device_busy``'s reduction (the union over
time of the device's kernel, memcpy and memset intervals, so nothing is
counted twice), taken here from the profiler's events instead of its
exported Chrome trace.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses

WINDOW = "perfbench.window"  # the span around the measured window


def busy_union(spans: list[tuple[float, float]]) -> tuple[float, list[tuple[float, float]]]:
    """(total length, merged intervals) of the union of ``spans``."""
    merged: list[list[float]] = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), [(a, b) for a, b in merged]


@dataclasses.dataclass
class TraceSummary:
    window_s: float  # the traced window's length (its span on the host)
    busy_s: float  # device busy seconds inside that window
    device_ops: dict  # kernel name -> [seconds, calls] over the whole trace
    top_ops: list  # [[name, seconds]] of the 10 costliest
    idle_gaps: list  # [[what the host did, seconds]] of the longest idle stretches


@dataclasses.dataclass
class Event:
    """One profiler event: its name, whether it ran on the device, its
    start and end in microseconds, and whether it is a span's annotation."""
    name: str
    device: bool
    start: float
    end: float
    annotation: bool = False


def events_of(prof) -> list:
    """The profiler's raw events (not its parsed tree, which takes minutes
    for a window of a few hundred thousand events)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns() / 1e3
        out.append(Event(e.name(), not str(e.device_type()).endswith("CPU"), a,
                         a + e.duration_ns() / 1e3, bool(e.is_user_annotation())))
    return out


def summarize(events, top: int = 10, gaps_examined: int = 500) -> TraceSummary:
    """Reduce a traced run's events (:func:`events_of`)."""
    device, host = [], []
    for e in events:
        if not e.device:
            host.append(e)
        elif not (e.annotation or e.name.startswith("perfbench.")):
            device.append(e)  # the spans' device-side copies are no work
    window = [e for e in host if e.name == WINDOW]
    if not window:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    w0, w1 = window[0].start, window[0].end
    ops: dict = {}
    spans = []
    for e in device:
        a, b = e.start, e.end
        row = ops.setdefault(e.name, [0.0, 0])
        row[0] += (b - a) * 1e-6
        row[1] += 1
        lo, hi = max(a, w0), min(b, w1)
        if hi > lo:
            spans.append((lo, hi))
    busy_us, merged = busy_union(spans)
    top_ops = [[n, s] for n, (s, _) in sorted(ops.items(), key=lambda kv: -kv[1][0])[:top]]
    # idle stretches inside the window, each named by the innermost host
    # span that holds its midpoint
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:gaps_examined]
    host = [e for e in host if e.name != WINDOW]
    host.sort(key=lambda e: e.start)
    starts = [e.start for e in host]
    by_what: dict = {}
    for length, a in gaps:
        mid = a + length / 2
        best, best_len = "host, outside any op", float("inf")
        i = bisect.bisect_right(starts, mid) - 1
        for e in host[max(0, i - 3000):i + 1]:
            span = e.end - e.start
            if e.end >= mid and span < best_len:
                best, best_len = e.name, span
        by_what[best] = by_what.get(best, 0.0) + length * 1e-6
    idle = [[n, s] for n, s in sorted(by_what.items(), key=lambda kv: -kv[1])[:top]]
    return TraceSummary(window_s=(w1 - w0) * 1e-6, busy_s=busy_us * 1e-6, device_ops=ops,
                        top_ops=top_ops, idle_gaps=idle)


@contextlib.contextmanager
def profiled(enabled: bool, device):
    """A profiler over the block when ``enabled`` (the card's activity
    too on a CUDA device); yields it, or None."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if str(device).startswith("cuda"):
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof


def span(prof, name: str):
    """A host span of the benchmark's own around a call into the program,
    or around the window (``WINDOW``); a no-op without a profiler."""
    if prof is None:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)
