"""``harness/spans.py`` on hand-made profiler events (each device operation
under the innermost program span around its launch call, self against
inclusive time, idle stretches by their midpoint, the outside row, the sum
check), the span tool's capture on the CPU, the new readers with nothing
to read, and the registry's new entries."""
from __future__ import annotations

import types

import pytest

from conftest import KV_LIMITS, KV_MIX, PREFILL_LIMITS, PREFILL_MIX, TINY_DENSE, TINY_MOE
from harness import common, spans
from harness.spans import OUTSIDE, Raw

BENCH = common.load_benchmark()
TOOL = common.load_module("tools", "span_table")
FILL = common.load_module("metrics", "moe_fill.prefill")
NEW = ("moe_fill.prefill",)


def _host(name, a, b, corr=0):
    return Raw(name, False, a, b, corr)


def _dev(name, a, b, corr, annotation=False):
    return Raw(name, True, a, b, corr, annotation)


# microseconds; the window 0-1000, spans nested as a prefill's are
EVENTS = [
    _host("perfbench.window", 0, 1000),
    _host("model.stack", 10, 500), _host("block.mixer", 20, 200), _host("attn.flash", 55, 100),
    _host("block.ffn", 200, 480), _host("moe.dispatch", 210, 300),
    _host("cudaLaunchKernel", 60, 62, 101),  # in attn.flash
    _host("aten::mm", 56, 70, 101),  # an operator's own id: not a launch call
    _host("cudaLaunchKernel", 30, 31, 102),  # block.mixer itself
    _host("cudaLaunchKernelExC", 220, 221, 103),  # in moe.dispatch
    _host("cudaMemcpyAsync", 250, 251, 105),  # in moe.dispatch
    _host("cudaLaunchKernel", 600, 601, 104),  # outside every program span
    _dev("flash_tc_kernel", 100, 300, 101), _dev("elementwise_kernel", 300, 350, 102),
    _dev("index_put_kernel", 350, 400, 103), _dev("Memcpy DtoD", 400, 410, 105),
    _dev("argmax_kernel", 700, 800, 104),
    _dev("nccl_kernel", 900, 950, 106),  # no launch call in the trace
    _dev("block.mixer", 100, 350, 0, annotation=True),  # a range's device-side copy
    _dev("perfbench.window", 0, 1000, 0),  # the window's device-side copy
]


def test_each_operation_goes_to_the_innermost_span_around_its_launch():
    rows, device_s = spans.attribute(EVENTS)
    self_us = {n: round(r.self_s * 1e6, 6) for n, r in rows.items()}
    assert self_us == {"model.stack": 0, "block.mixer": 50, "attn.flash": 200, "block.ffn": 0,
                       "moe.dispatch": 60, OUTSIDE: 150}
    assert device_s == pytest.approx(460e-6)
    assert rows["moe.dispatch"].ops == pytest.approx({"index_put_kernel": 50e-6,
                                                      "Memcpy DtoD": 10e-6})
    assert TOOL.top_ops(rows[OUTSIDE], 1) == [["argmax_kernel", pytest.approx(100e-6)]]


def test_inclusive_time_adds_the_child_spans_and_self_time_does_not():
    rows, _ = spans.attribute(EVENTS)
    incl_us = {n: round(r.incl_s * 1e6, 6) for n, r in rows.items()}
    assert incl_us == {"model.stack": 310, "block.mixer": 250, "attn.flash": 200,
                       "block.ffn": 60, "moe.dispatch": 60, OUTSIDE: 150}
    assert (rows["model.stack"].calls, rows["model.stack"].host_s) == (1, pytest.approx(490e-6))
    assert spans.self_seconds(rows, ("block.mixer", "moe.dispatch")) == pytest.approx(110e-6)
    assert spans.inclusive_seconds(rows, "block.mixer") == pytest.approx(250e-6)


def test_idle_stretches_go_to_the_span_that_holds_their_midpoint():
    rows, _ = spans.attribute(EVENTS)
    idle_us = {n: round(r.idle_s * 1e6, 6) for n, r in rows.items() if r.idle_s}
    # busy 100-410, 700-800, 900-950: the stretch 0-100 has its midpoint in
    # block.mixer (attn.flash opens at 55); the others lie outside every span
    assert idle_us == {"block.mixer": 100, OUTSIDE: 290 + 100 + 50}
    assert sum(r.idle_s for r in rows.values()) == pytest.approx(1000e-6 - 460e-6)


def test_the_rows_self_seconds_sum_to_the_device_seconds():
    rows, device_s = spans.attribute(EVENTS)
    assert sum(r.self_s for r in rows.values()) == pytest.approx(device_s)
    assert spans.inside_share(rows, device_s) == pytest.approx(100 * (1 - 150 / 460))
    lines = spans.table(rows, device_s)
    assert any(line.startswith(OUTSIDE) for line in lines)
    assert lines[-1].startswith("sum of self_s 0.000460 s, device 0.000460 s")


def test_operations_with_no_launch_call_and_traces_with_no_span():
    ops = [e for e in EVENTS if e.device or e.name == "perfbench.window"]
    rows, device_s = spans.attribute(ops)
    assert set(rows) == {OUTSIDE} and rows[OUTSIDE].self_s == pytest.approx(device_s)
    assert spans.inside_share(rows, device_s) == pytest.approx(0.0)
    assert spans.self_seconds(rows, ("moe.route",)) is None
    assert spans.inclusive_seconds(rows, "kv.park") is None
    assert spans.self_seconds(None, ("moe.route",)) is None
    rows, device_s = spans.attribute([])
    assert device_s == 0.0 and spans.inside_share(rows, device_s) is None


@pytest.mark.parametrize("view", [
    types.SimpleNamespace(mc=TINY_MOE, counted=[10], dispatched=[10], window_s=1.0, trace=None),
    types.SimpleNamespace(elements=[512], block=256, window_s=1.0, trace=None)],
    ids=["prefill", "kv"])
def test_new_readings_are_absent_without_spans_or_counts(view):
    from repro_torch.core import trace

    trace.reset_counts()
    assert TOOL.readings(view, None) == {}
    assert FILL.read(view) is None and FILL.read(None) is None


def test_the_fill_reads_the_ports_counters():
    from repro_torch.core import trace
    from torch.profiler import ProfilerActivity, profile

    trace.reset_counts()
    with profile(activities=[ProfilerActivity.CPU]):
        trace.count("moe.kept", 30)
        trace.count("moe.slots", 40)
    view = types.SimpleNamespace(trace=None)
    assert FILL.read(view) == pytest.approx(75.0)
    trace.reset_counts()


def test_readings_from_rows():
    rows = {"moe.route": spans.Row(self_s=2e-3), "moe.aux": spans.Row(self_s=1e-3),
            "block.mixer": spans.Row(self_s=4e-3), "kv.park": spans.Row(incl_s=1e-3),
            OUTSIDE: spans.Row()}
    prefill = types.SimpleNamespace(dispatched=[1000, 2000])
    assert TOOL.readings(prefill, rows) == pytest.approx(
        {"moe_route_us.prefill": 1.0, "mixer_self_us.prefill": 4e3 / 3e3})
    kv = types.SimpleNamespace(elements=[512], block=256)
    rq = common.load_module("metrics", "residual_quant_roofline.kv")
    from harness.peaks import HBM_BYTES_PER_S

    want = 100 * 2 * rq.park_bytes(512, 256) / HBM_BYTES_PER_S / 1e-3
    assert TOOL.readings(kv, rows) == pytest.approx({"park_roofline.kv": want})


@pytest.mark.parametrize("cell, mc, mix, limits, names", [
    ("deepseek-v2-lite-16b.prefill-long", TINY_MOE, PREFILL_MIX, PREFILL_LIMITS,
     {"model.stack", "block.ffn", "moe.dispatch", "attn.flash"}),
    ("mistral-nemo-12b.kv-park", TINY_DENSE, KV_MIX, KV_LIMITS,
     {"kv.park", "kv.restore", "codec.step", "codec.dequant"})], ids=["prefill", "kv"])
def test_the_tool_keeps_a_traced_runs_spans(make_job, cell, mc, mix, limits, names):
    from repro_torch.core import trace

    trace.reset_counts()
    job = make_job(cell, mc, mix, limits, seconds=0.3, trace=True)
    out, rows, device_s = TOOL.traced_run(job)
    assert names <= set(rows) and device_s == 0.0  # the CPU: no device operations
    traced = len(out.view.dispatched) if hasattr(out.view, "dispatched") else len(
        out.view.elements)
    top = "model.stack" if "model.stack" in names else "kv.park"
    assert rows[top].calls == traced
    if "moe.dispatch" in names:
        assert 0.0 < FILL.read(out.view) <= 80.0
    trace.reset_counts()


def test_registry_takes_the_new_entries():
    cells = {c["name"] for c in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("host_clock", "device_trace", "program_counter")
        assert set(m.get("workloads", cells)) <= cells
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for name in NEW:
        m = entries[name]
        assert m["workloads"] and callable(common.load_module("metrics", name).read)
        assert m["layer"] and "\n" not in m["layer"] and len(m["layer"]) <= 200
