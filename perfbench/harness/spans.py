"""Device time and idle time of a traced run by the program's own spans.

The port records its layers as host ranges while a profiler records
(``repro_torch.core.trace``: ``model.*``, ``block.*``, ``attn.*``,
``moe.*``, ``kv.*``, ``codec.*``).  :func:`attribute` gives each device
operation (kernel, memcpy, memset) to the innermost such span that holds
the host call that launched it: the operation and its launch call
(``cudaLaunchKernel``, ``cuLaunchKernelEx``, ``cudaMemcpyAsync``, ...)
share the profiler's correlation id.  The ranges' device-side copies are
not used: they stretch over idle time and over child spans.  Each idle
stretch of the traced window goes to the innermost span that holds its
midpoint on the host, the rule of ``trace.summarize``.  Work launched
outside every program span (the benchmark's own token draws and copies)
and idle time outside them go to the row ``OUTSIDE``.

Spans nest within one host thread; the port's spans are all on the thread
that calls it.
"""
from __future__ import annotations

import dataclasses

from .trace import WINDOW, busy_union

PREFIXES = ("model.", "block.", "attn.", "moe.", "kv.", "codec.")
OUTSIDE = "(outside any program span)"
LAUNCHES = ("cu",)  # the CUDA runtime's and driver's calls: cudaLaunchKernel, cuLaunchKernelEx


@dataclasses.dataclass
class Raw:
    """One profiler event: its name, whether it ran on the device, its
    start and end in microseconds, its correlation id, and whether it is
    a user annotation (a range's device-side copy, on the device)."""
    name: str
    device: bool
    start: float
    end: float
    corr: int
    annotation: bool = False


@dataclasses.dataclass
class Row:
    """A span name's totals: its calls and host seconds (inclusive), the
    device seconds of the operations it launched itself (``self_s``, and
    by operation name in ``ops``) and with those of its child spans
    (``incl_s``), and the idle seconds of the window that fell inside it
    with no child span around them."""
    calls: int = 0
    host_s: float = 0.0
    self_s: float = 0.0
    incl_s: float = 0.0
    idle_s: float = 0.0
    ops: dict = dataclasses.field(default_factory=dict)

    def add(self, name: str, seconds: float) -> None:
        self.self_s += seconds
        self.ops[name] = self.ops.get(name, 0.0) + seconds


def raw_events(prof) -> list:
    """The profiler's raw events with their correlation ids (as
    ``trace.events_of``: not the parsed tree)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns() / 1e3
        out.append(Raw(e.name(), not str(e.device_type()).endswith("CPU"), a,
                       a + e.duration_ns() / 1e3, e.correlation_id(),
                       bool(e.is_user_annotation())))
    return out


def _is_op(e: Raw) -> bool:
    """A device operation, as ``trace.summarize`` counts them."""
    return e.device and not (e.annotation or e.name.startswith("perfbench."))


def _holders(spans: list, points: list) -> list:
    """For each point (host microseconds) the program spans open at it,
    outermost first: one sweep over both in time order."""
    order = sorted(range(len(points)), key=points.__getitem__)
    out: list = [None] * len(points)
    open_: list = []
    i = 0
    for j in order:
        t = points[j]
        while i < len(spans) and spans[i].start <= t:
            open_.append(spans[i])
            i += 1
        open_ = [s for s in open_ if s.end >= t]
        out[j] = list(open_)
    return out


def attribute(events: list) -> tuple[dict, float]:
    """({span name: Row}, the trace's device seconds): every device
    operation of ``events`` (:func:`raw_events`) under the span that
    launched it, the ``OUTSIDE`` row included, so that the rows' ``self_s``
    sum to the device seconds."""
    spans = sorted((e for e in events if not e.device and e.name.startswith(PREFIXES)),
                   key=lambda e: (e.start, -e.end))
    launch = {e.corr: e.start for e in events
              if not e.device and e.name.startswith(LAUNCHES)}
    ops = [e for e in events if _is_op(e)]
    rows: dict = {OUTSIDE: Row()}
    for s in spans:
        row = rows.setdefault(s.name, Row())
        row.calls += 1
        row.host_s += (s.end - s.start) * 1e-6
    launched = [e for e in ops if e.corr in launch]
    for e in ops:
        if e.corr not in launch:  # no launch call in the trace: nothing holds it
            rows[OUTSIDE].add(e.name, (e.end - e.start) * 1e-6)
            rows[OUTSIDE].incl_s += (e.end - e.start) * 1e-6
    for e, held in zip(launched, _holders(spans, [launch[e.corr] for e in launched])):
        took = (e.end - e.start) * 1e-6
        inner = rows[held[-1].name] if held else rows[OUTSIDE]
        inner.add(e.name, took)
        for name in {s.name for s in held} or {OUTSIDE}:
            rows[name].incl_s += took
    window = [e for e in events if not e.device and e.name == WINDOW]
    if window and ops:
        w0, w1 = window[0].start, window[0].end
        _, merged = busy_union([(max(e.start, w0), min(e.end, w1)) for e in ops
                                if min(e.end, w1) > max(e.start, w0)])
        edges = [w0] + [x for ab in merged for x in ab] + [w1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        for (a, b), held in zip(gaps, _holders(spans, [(a + b) / 2 for a, b in gaps])):
            rows[held[-1].name if held else OUTSIDE].idle_s += (b - a) * 1e-6
    return rows, sum((e.end - e.start) * 1e-6 for e in ops)


def inside_share(rows: dict, device_s: float):
    """Percent of the device seconds launched inside some program span."""
    if device_s <= 0.0:
        return None
    return 100.0 * (1.0 - rows[OUTSIDE].self_s / device_s)


def table(rows: dict, device_s: float) -> list[str]:
    """The rows as text, by self device seconds, and the sum check."""
    lines = [f"{'span':28s} {'calls':>7s} {'host_s':>9s} {'self_s':>9s} {'self%':>6s} "
             f"{'incl_s':>9s} {'idle_s':>8s}"]
    for name, r in sorted(rows.items(), key=lambda kv: -kv[1].self_s):
        pct = 100.0 * r.self_s / device_s if device_s > 0 else 0.0
        lines.append(f"{name:28s} {r.calls:7d} {r.host_s:9.4f} {r.self_s:9.4f} {pct:6.2f} "
                     f"{r.incl_s:9.4f} {r.idle_s:8.4f}")
    total = sum(r.self_s for r in rows.values())
    share = inside_share(rows, device_s)
    lines.append(f"sum of self_s {total:.6f} s, device {device_s:.6f} s; inside program spans "
                 f"{'-' if share is None else f'{share:.2f}'}%")
    return lines


def self_seconds(rows, names) -> float | None:
    """Self device seconds of the named spans together; None where none of
    them is in the trace."""
    if rows is None or not any(n in rows for n in names):
        return None
    return sum(rows[n].self_s for n in names if n in rows)


def inclusive_seconds(rows, name: str) -> float | None:
    """Device seconds of every operation launched under ``name``; None
    where the span is not in the trace."""
    if rows is None or name not in rows:
        return None
    return rows[name].incl_s
