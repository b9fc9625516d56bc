"""One traced run of a cell, with its device and idle time put on the
port's own spans (``harness/spans.py``), from the root of a checkout:

    python3 perfbench/tools/span_table.py --workload <cell> --seed <n> --seconds <s>

It runs the cell's runner as ``run.py --trace 1`` does (the same set-up,
windows and check) and keeps the profiler's raw events as the runner
reduces them.  On standard error: the span table (calls, host seconds,
self and inclusive device seconds, idle seconds; the row of work launched
outside every program span; the sum check).  On standard output, one JSON
line: ``correct``, the requests of the traced window (``traced``: prompts
dispatched, or sessions restored and parked), the per-layer metrics the
cell reports, the port's counters, the rows (each with its costliest
device operations by name), the share of device seconds
launched inside a program span, and ``readings``, the per-span numbers
that ``metrics/`` has no view to read yet:

- ``moe_route_us.prefill``, ``moe_dispatch_us.prefill``,
  ``moe_combine_us.prefill``, ``mixer_self_us.prefill``: self device
  microseconds of ``moe.route`` + ``moe.aux``, ``moe.dispatch``,
  ``moe.combine``, ``block.mixer`` a prompt token dispatched in the window;
- ``park_roofline.kv``, ``restore_roofline.kv``: the bytes of
  ``residual_quant_roofline.kv`` and ``dequant_roofline.kv`` at the
  memory's rate over the device time of every operation under ``kv.park``
  and ``kv.restore``.

On a port without spans every row is the outside one and the readings
are absent.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import sys
import time

T0 = time.perf_counter()
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from harness import common, main, spans  # noqa: E402
from harness import trace as htrace  # noqa: E402
from harness.peaks import HBM_BYTES_PER_S  # noqa: E402
from harness.readers import share  # noqa: E402

PER_TOKEN = {"moe_route_us.prefill": ("moe.route", "moe.aux"),
             "moe_dispatch_us.prefill": ("moe.dispatch",),
             "moe_combine_us.prefill": ("moe.combine",),
             "mixer_self_us.prefill": ("block.mixer",)}
ROOFLINE = {"park_roofline.kv": ("kv.park", "residual_quant_roofline.kv", "park_bytes"),
            "restore_roofline.kv": ("kv.restore", "dequant_roofline.kv", "restore_bytes")}


def readings(view, rows) -> dict:
    """The per-span numbers of the module's docstring that ``rows`` holds."""
    out = {}
    if hasattr(view, "dispatched"):
        tokens = sum(view.dispatched)
        for name, spans_of in PER_TOKEN.items():
            s = spans.self_seconds(rows, spans_of)
            if s is not None and tokens:
                out[name] = 1e6 * s / tokens
    if hasattr(view, "elements"):
        for name, (span, metric, fn) in ROOFLINE.items():
            took = spans.inclusive_seconds(rows, span)
            nbytes = getattr(common.load_module("metrics", metric), fn)
            need = sum(2 * nbytes(n, view.block) for n in view.elements)
            if took is not None and (value := share(need / HBM_BYTES_PER_S, took)) is not None:
                out[name] = value
    return out


def top_ops(row, n: int = 8) -> list:
    """A row's ``n`` costliest device operations: [[name, seconds]]."""
    return [[k, v] for k, v in sorted(row.ops.items(), key=lambda kv: -kv[1])[:n]]


def traced_run(job) -> tuple:
    """(the runner's outcome, the span rows, the trace's device seconds) of
    ``job`` run traced, its raw events kept as the runner reduces them."""
    captured = []
    reduce = htrace.events_of

    def events_of(prof):  # the runner binds this name when it is loaded below
        captured.append(spans.raw_events(prof))
        return reduce(prof)

    htrace.events_of = events_of
    try:
        out = common.load_module("runners", job.mix["runner"]).run(job)
    finally:
        htrace.events_of = reduce
    rows, device_s = spans.attribute(captured[0])
    return out, rows, device_s


def cli(argv) -> int:
    p = argparse.ArgumentParser(prog="perfbench/tools/span_table.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    job = main.prepare(["--workload", args.workload, "--seed", str(args.seed),
                        "--seconds", str(args.seconds), "--trace", "1"])
    job.t0 = T0
    out, rows, device_s = traced_run(job)
    print("\n".join(spans.table(rows, device_s)), file=sys.stderr)
    view = out.view
    metrics = {}
    for m in common.cell_metrics(job.bench, job.cell["name"], "per_layer"):
        value = common.load_module("metrics", m["name"]).read(view)
        if value is not None:
            metrics[m["name"]] = value
    try:
        from repro_torch.core import trace as program_trace
        counts = program_trace.counts()
    except ImportError:  # a port without counters
        counts = None
    traced = len(view.dispatched) if hasattr(view, "dispatched") else len(view.elements)
    result = {"workload": args.workload, "seed": args.seed,
              "correct": out.failed == 0 and all(math.isfinite(v) and v <= lim
                                                 for _, v, lim in out.checks),
              "traced": traced, "window_s": view.trace.window_s, "busy_s": view.trace.busy_s,
              "metrics": metrics, "counts": counts,
              "inside_share": spans.inside_share(rows, device_s), "device_s": device_s,
              "rows": {n: {**vars(r), "ops": top_ops(r)} for n, r in rows.items()},
              "readings": readings(view, rows)}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(cli(sys.argv[1:]))
