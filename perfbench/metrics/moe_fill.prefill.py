"""moe_fill.prefill: the share of the MoE's expert-buffer rows that carry
a token, 100 x ``moe.kept`` / ``moe.slots``, as the port counts them
(``repro_torch.core.trace``) while the profiler records: in a traced run,
over every MoE layer of every request of the traced window.  The rest of
the rows are capacity padding that the expert products compute all the
same; a capacity factor of 1.25 caps the share at 80%.  Nothing where the
port keeps no such counters."""


def read(view):
    if view is None:
        return None
    try:
        from repro_torch.core import trace
    except ImportError:  # a port without its counters
        return None
    c = trace.counts()
    if not c.get("moe.slots"):
        return None
    return 100.0 * c.get("moe.kept", 0) / c["moe.slots"]
