"""One run of one cell: parse the arguments, check the machine, run the
cell's runner, read the per-layer metrics of a traced run, check that no
JAX module was loaded, and print the result line."""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys

from . import common
from .common import BenchError


@dataclasses.dataclass
class Job:
    """What a runner gets: the cell and its files, the run's arguments."""
    bench: dict
    cell: dict
    config: dict  # configs/<config>.json
    mix: dict  # traffic/<traffic>.json
    limits: dict  # limits/<cell>.json
    seed: int
    seconds: float
    trace: bool
    device: object  # torch.device
    t0: float  # perf_counter at process start


@dataclasses.dataclass
class Outcome:
    """What a runner returns."""
    metrics: dict  # end-to-end metric name -> value
    attempted: int
    failed: int
    checks: list  # [(short name, value, limit)]: correct iff every value <= its limit
    memory_peak_bytes: int
    view: object = None  # what the per-layer readers read (traced runs)


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="perfbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_dirs(root) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths (the
    port's nvcc libraries already go to ``build/repro_torch_kernels``)."""
    base = root / "build" / "perfbench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = str(base / sub)


def prepare(argv, device=None, root=common.ROOT):
    """The job of ``argv``; ``device`` None means the card, which it checks."""
    args = parse(argv)
    bench = common.load_benchmark(root)
    cell = common.find_cell(bench, args.workload)
    if not (root / "src" / "repro_torch").is_dir():
        raise BenchError("the port (src/repro_torch) is not in this checkout")
    sys.path.insert(0, str(root / "src"))
    cache_dirs(root)
    mix = common.read_json(common.traffic_file(cell["traffic"]))
    if "allocator" in mix:  # read when torch first touches the card
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = mix["allocator"]
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise BenchError("no CUDA device")
        if torch.cuda.device_count() < cell["chips"]:
            raise BenchError(f"{cell['name']} needs {cell['chips']} cards, "
                             f"{torch.cuda.device_count()} here")
        device = torch.device("cuda", 0)
    return Job(bench=bench, cell=cell,
               config=common.read_json(common.config_file(cell["config"])),
               mix=mix,
               limits=common.read_json(common.limits_file(cell["name"])),
               seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
               device=torch.device(device), t0=0.0)


def execute(job: Job) -> dict:
    """Run the job's cell and return the result line's object."""
    import torch

    runner = common.load_module("runners", job.mix["runner"])
    out: Outcome = runner.run(job)
    table = "per_layer" if job.trace else "end_to_end"
    metrics = {}
    for m in common.cell_metrics(job.bench, job.cell["name"], table):
        if job.trace:
            value = common.load_module("metrics", m["name"]).read(out.view)
        else:
            value = out.metrics.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = job.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": job.cell["chips"], "memory_peak_bytes": out.memory_peak_bytes}
    checks = [(n, v if math.isfinite(v) else 1e300, lim) for n, v, lim in out.checks]
    result = {"correct": out.failed == 0 and all(v <= lim for _, v, lim in checks),
              "attempted": out.attempted, "failed": out.failed, "metrics": metrics,
              "device": device}
    if job.trace and out.view is not None and out.view.trace is not None:
        t = out.view.trace
        device["busy_s"], device["window_s"] = t.busy_s, t.window_s
        result["breakdown"] = {"device_ops": t.top_ops, "idle_gaps": t.idle_gaps}
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return result


def report(result: dict) -> None:
    """Each compared number beside its limit as the last lines on standard
    error, then the result as the last line on standard output."""
    for name, c in result["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAILED"
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} {verdict}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv, t0: float) -> int:
    try:
        job = prepare(argv)
        job.t0 = t0
        result = execute(job)
    except BenchError as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    found = common.forbidden_modules()
    if found:
        print(f"perfbench: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    report(result)
    return 0
