#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--series 1024] [--samples 16384] [--seed 0] [--trace DIR]

Phases, each of which must pass (any failure exits non-zero before the
result line):

1. card: name and power limit from nvidia-smi; build every CUDA kernel
   from ``src/repro_torch/kernels/csrc`` (one nvcc per source, in parallel).
2. main path, the IoT gateway batch: ``ShrinkCodec.compress_batch`` on S
   seeded random walks of T samples (tiers 1e-1, 1e-2, 1e-3 and lossless,
   4 decimals, eps_b = 5% of the range, rANS), then ``decompress_at`` of
   every series at 0.0 (bit-identical to the input) and a progressive
   decode of every tier (|v_hat - v| <= eps).  Kernel launch counts are
   zeroed just before and read just after; each kernel must have run.
3. kernels: each kernel against its plain torch version on the card, on
   the inputs the main path gave it, exactly (torch.equal); the cone scan
   also once in float32.  Times from CUDA events.
4. device route vs CPU route: 8 series through ``device="cpu"`` give the
   same SHRK bytes.
5. golden files: ``tests/golden/golden_v4*.shrk`` decode losslessly on the
   card and re-encode byte for byte.

With ``--trace DIR`` a sixth phase times the main path stage by stage
(the codec's own functions, called in its order) and traces one
compress_batch and the lossless decode of 64 series with torch.profiler:
device time by kernel and copy, the device busy share (the union of the
trace's device events over the profiled window), and a Chrome trace in
DIR.

The last two lines are the kernels line and the result line:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s; FP64 outside
# the tensor cores; INT32 as 132 SMs x 64 INT32 lanes x 1.98 GHz boost (one
# operation per lane-cycle).
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
TIERS = [1e-1, 1e-2, 1e-3, 0.0]
DECIMALS = 4
GOLDEN_N, GOLDEN_DECIMALS = 1536, 3  # tests/golden/regen.py


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def sync_time(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def event_ms(fn, reps: int) -> float:
    """Mean time of one call on the card, from CUDA events around ``reps``
    calls after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def max_abs_err(got, want) -> float:
    """Largest |kernel - plain| over all outputs (equal entries count 0)."""
    worst = 0.0
    for a, b in zip(got, want):
        if a.shape != b.shape:
            return float("inf")
        d = (a.double() - b.double()).abs()
        d[a == b] = 0.0
        if d.numel():
            worst = max(worst, float(d.nan_to_num(nan=float("inf")).max()))
    return worst


class Recorder:
    """Stands in for a module attribute and keeps the arguments of the
    first call, so the kernels can be checked and timed on exactly the
    inputs the main path gave them."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.args = None
        setattr(module, name, self)

    def __call__(self, *args, **kwargs):
        if self.args is None:
            self.args = (args, kwargs)
        return self.orig(*args, **kwargs)

    def restore(self) -> None:
        setattr(self.module, self.name, self.orig)


def gateway_batch(series: int, samples: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.round(np.cumsum(rng.standard_normal((series, samples)), axis=1) * 0.1, 4)


def tier_bound(eps: float, v: torch.Tensor) -> float:
    """The repo's per-tier bound: eps plus a few ulps of the data scale
    (tests/test_pyramid_property.py)."""
    return eps * (1 + 1e-9) + 4 * float(np.finfo(np.float64).eps) * max(1.0, float(v.abs().max()))


def main_path(P, values: np.ndarray, dev: torch.device) -> dict:
    codec = P.ShrinkCodec.from_fraction(values, frac=0.05, backend="rans", device=dev)
    v = torch.as_tensor(values, device=dev)
    torch.cuda.reset_peak_memory_stats()
    css, t_compress = sync_time(lambda: codec.compress_batch(v, TIERS, decimals=DECIMALS))
    blobs = [P.cs_to_bytes(cs) for cs in css]
    parsed = [P.cs_from_bytes(b) for b in blobs]
    outs, t_decode = sync_time(lambda: [codec.decompress_at(cs, 0.0) for cs in parsed])
    for i, out in enumerate(outs):
        check(torch.equal(out, v[i]), f"series {i}: lossless decode differs from the input")
    del outs
    worst = [0.0] * len(TIERS)
    for i, cs in enumerate(parsed):
        dec = P.ProgressiveDecoder(cs, dev)
        for k, eps in enumerate(TIERS):
            err = float((dec.prefix(k) - v[i]).abs().max())
            check(err <= tier_bound(eps, v[i]), f"series {i} tier {eps}: error {err}")
            worst[k] = max(worst[k], err)
    archive = sum(len(b) for b in blobs)
    return {
        "codec": codec,
        "blobs": blobs,
        "series": values.shape[0],
        "samples": values.shape[1],
        "archive_bytes": archive,
        "compression_ratio": P.BYTES_PER_ROW * values.size / archive,
        "compress_s": t_compress,
        "decompress_at_lossless_s": t_decode,
        "max_tier_error": dict(zip(map(str, TIERS), worst)),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "segments": sum(cs.base.segment_count() for cs in css),
    }


def check_cone_scan(cs_mod, x, eps, launches: int) -> dict:
    """The float64 kernel (the main path's) and the float32 one, each against
    its plain version; the row describes the float64 kernel and carries the
    float32 check beside it."""
    t_len, s = x.shape
    res = {}
    for dtype in (torch.float64, torch.float32):
        xd, ed = x.to(dtype), eps.to(dtype)
        got = cs_mod.cone_scan_cuda(xd, ed)
        want, plain_s = sync_time(lambda: cs_mod.cone_scan_plain(xd, ed))
        err = max_abs_err(got, want)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"cone_scan {dtype} kernel differs from its plain version (max err {err})")
        ms = event_ms(lambda: cs_mod.cone_scan_cuda(xd, ed), 5)
        res[dtype] = (err, ms, plain_s * 1e3)
    # bytes: x and eps read, brk (int32) + theta + psi_lo + psi_hi written
    nbytes = t_len * s * (8 + 8 + 4 + 8 + 8 + 8) + 2 * s * 8
    ops = 9 * t_len * s  # 4 adds, 2 divisions, 3 compares per point
    err, ms, plain_ms = res[torch.float64]
    return {
        "name": "cone_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/cone_scan.cu",
        "replaces": "src/repro/kernels/cone_scan.py:41",
        "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / FP64_OPS_PER_S),
        "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= ops / FP64_OPS_PER_S
        else "operations",
        "library_ms": None, "shape": [t_len, s], "dtype": "float64",
        "f32_max_abs_err": res[torch.float32][0], "f32_ms": res[torch.float32][1],
        "f32_plain_ms": res[torch.float32][2],
    }


def check_rans(rk, enc_args, dec_args, launches: dict) -> list[dict]:
    sym, freqs, k = enc_args
    r, n = sym.shape
    steps = -(-n // k)
    cells = torch.full((r, steps * k), rk.ID_SYM, dtype=torch.int16, device=sym.device)
    cells[:, :n] = sym
    freqs = freqs.long()
    got = rk.encode_cells_cuda(cells, freqs, k)
    want, plain_s = sync_time(lambda: rk.encode_cells_plain(cells, freqs, k))
    err = max_abs_err(got, want)
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          f"rans_encode kernel differs from its plain version (max err {err})")
    ms = event_ms(lambda: rk.encode_cells_cuda(cells, freqs, k), 10)
    n_cells = r * steps * k
    enc_bytes = n_cells * (2 + 1 + 2) + r * 256 * 8 + r * k * 8
    enc_ops = 10 * n_cells
    rows = [{
        "name": "rans_encode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rans.cu",
        "replaces": "src/repro/kernels/rans.py:77",
        "launches": launches["rans_encode"], "max_abs_err": err, "ms": ms,
        "plain_ms": plain_s * 1e3,
        "bound_ms": 1e3 * max(enc_bytes / HBM_BYTES_PER_S, enc_ops / INT32_OPS_PER_S),
        "bound_by": "bytes" if enc_bytes / HBM_BYTES_PER_S >= enc_ops / INT32_OPS_PER_S
        else "operations",
        "library_ms": None, "rows": r, "steps": steps, "lanes": k, "cells": n_cells,
    }]
    states, freqs_d, words, word_off, word_cnt, ns, kd = dec_args[0]
    rd = states.shape[0]
    cols = int((-(-ns // kd)).max()) * kd
    got = rk.decode_rows_cuda(states, freqs_d, words, word_off, word_cnt, ns, kd, cols)
    want, plain_s = sync_time(
        lambda: rk.decode_rows_plain(states, freqs_d, words, word_off, word_cnt, ns, kd, cols)
    )
    err = max_abs_err(got, want)
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          f"rans_decode kernel differs from its plain version (max err {err})")
    ms = event_ms(lambda: rk.decode_rows_cuda(states, freqs_d, words, word_off, word_cnt, ns, kd,
                                              cols), 20)
    d_cells = rd * cols
    dec_bytes = words.numel() * 2 + rd * (kd * 8 + 256 * 8 + 3 * 8) + d_cells + rd * 8
    dec_ops = 10 * d_cells
    rows.append({
        "name": "rans_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rans.cu",
        "replaces": "src/repro/kernels/rans.py:148",
        "launches": launches["rans_decode"], "max_abs_err": err, "ms": ms,
        "plain_ms": plain_s * 1e3,
        "bound_ms": 1e3 * max(dec_bytes / HBM_BYTES_PER_S, dec_ops / INT32_OPS_PER_S),
        "bound_by": "bytes" if dec_bytes / HBM_BYTES_PER_S >= dec_ops / INT32_OPS_PER_S
        else "operations",
        "library_ms": None, "rows": rd, "steps": cols // kd, "lanes": kd, "cells": d_cells,
    })
    return rows


def trace_main_path(P, values: np.ndarray, codec, dev, out_dir: pathlib.Path) -> dict:
    """Stage times of compress_batch and decompress_at (host clock after a
    synchronize, calling the codec's stages in its own order), then one
    profiled compress_batch + lossless decode of 64 series."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import base as B
    from repro_torch.core import phases as Ph
    from repro_torch.core import residuals as Rz
    from repro_torch.core import semantics as Sm
    from repro_torch.core import serialize as Sz
    from repro_torch.kernels import ops

    v = torch.as_tensor(values, device=dev)
    cfg = codec.config
    t: dict[str, float] = {}
    (lv, eps), t["fluctuation_table"] = sync_time(
        lambda: Ph.fluctuation_table(v, v.amax(1) - v.amin(1), cfg))
    scan, t["cone_scan_kernel"] = sync_time(
        lambda: ops.cone_scan(v.T.contiguous(), eps.T.contiguous()))
    _, t["compact_segments"] = sync_time(lambda: ops.compact_segments(*scan))
    del lv, eps, scan
    segs, t["extract_semantics_batch_total"] = sync_time(
        lambda: Sm.extract_semantics_batch(v, cfg))
    vmins, vmaxs = v.amin(1).tolist(), v.amax(1).tolist()
    n = v.shape[1]
    bases, t["construct_base_host"] = sync_time(lambda: [
        B.construct_base(segs[i], n, vmins[i], vmaxs[i], cfg) for i in range(len(segs))])
    _, t["encode_base_host"] = sync_time(lambda: [Sz.encode_base(b) for b in bases])
    preds, t["base_predictions_batch"] = sync_time(lambda: B.base_predictions_batch(bases, dev))
    tiers = Rz.normalize_tiers(TIERS, DECIMALS)
    streams, t["quantize_pyramid_batch"] = sync_time(
        lambda: Rz.quantize_pyramid_batch(v, preds, tiers, DECIMALS))
    todo = [st for row in streams for st in row if st is not None]
    _, t["entropy_encode"] = sync_time(lambda: Rz.encode_residuals_batch(todo))
    css, t["compress_batch_total"] = sync_time(
        lambda: codec.compress_batch(v, TIERS, decimals=DECIMALS))
    blobs = [P.cs_to_bytes(cs) for cs in css[:64]]
    parsed, t["cs_from_bytes_64"] = sync_time(lambda: [P.cs_from_bytes(b) for b in blobs])
    _, t["decompress_at_lossless_64"] = sync_time(
        lambda: [codec.decompress_at(cs, 0.0) for cs in parsed])
    del preds, streams, todo, css

    out_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall0 = time.perf_counter()
        css = codec.compress_batch(v, TIERS, decimals=DECIMALS)
        torch.cuda.synchronize()
        wall_c = time.perf_counter() - wall0
        parsed = [P.cs_from_bytes(P.cs_to_bytes(cs)) for cs in css[:64]]
        torch.cuda.synchronize()
        wall1 = time.perf_counter()
        for cs in parsed:
            codec.decompress_at(cs, 0.0)
        torch.cuda.synchronize()
        wall_d = time.perf_counter() - wall1
        wall_all = time.perf_counter() - wall0
    trace_path = out_dir / "main_path_trace.json"
    prof.export_chrome_trace(str(trace_path))
    busy_ms, ops_ms = device_busy(trace_path)
    top = dict(sorted(ops_ms.items(), key=lambda kv: -kv[1]["device_ms"])[:15])
    trace = {
        "stage_s": t,
        "profiled_wall_s": {"compress_batch": wall_c, "cs_from_bytes+decompress_at_64": wall_d,
                            "window": wall_all},
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / 1e3 / wall_all,
        "top_device_ops": top,
    }
    (out_dir / "main_path_trace_summary.json").write_text(json.dumps(trace, indent=1))
    return trace


DEVICE_EVENTS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_busy(trace_path: pathlib.Path) -> tuple[float, dict]:
    """Device busy time of a torch.profiler Chrome trace: the union over
    time of its kernel, memcpy and memset events (host-side op events are
    left out, so nothing is counted twice), and the device time by event
    name."""
    events = json.loads(trace_path.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    spans, by_name = [], {}
    for e in events:
        if e.get("cat") not in DEVICE_EVENTS or e.get("ph") != "X":
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        spans.append((ts, ts + dur))
        row = by_name.setdefault(e["name"], {"device_ms": 0.0, "calls": 0})
        row["device_ms"] += dur / 1e3
        row["calls"] += 1
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return busy_us / 1e3, by_name


def golden_series() -> np.ndarray:
    t = np.arange(GOLDEN_N, dtype=np.float64)
    v = np.sin(t * 0.02) * 2.5 + 0.3 * np.sign(np.sin(t * 0.15)) + 1e-3 * t
    return np.round(v, GOLDEN_DECIMALS)


def check_golden(P, dev) -> list[str]:
    v = golden_series()
    rng = float(v.max() - v.min())
    codec = P.ShrinkCodec(P.ShrinkConfig(eps_b=0.05 * rng, lam=1e-3), device=dev)
    cases = {
        "golden_v4.shrk": [1e-2, 0.0],
        "golden_v4_pyramid.shrk": [1e-1 * rng, 1e-2 * rng, 1e-3 * rng, 0.0],
    }
    for name, tiers in cases.items():
        blob = (ROOT / "tests" / "golden" / name).read_bytes()
        cs = P.cs_from_bytes(blob)
        out = codec.decompress_at(cs, 0.0)
        check(torch.equal(out.cpu(), torch.as_tensor(v)), f"{name}: lossless decode differs")
        check(P.cs_to_bytes(cs) == blob, f"{name}: parse + re-encode differs")
        check(P.cs_to_bytes(codec.compress(v, tiers, decimals=GOLDEN_DECIMALS)) == blob,
              f"{name}: compress on the card differs from the fixture")
    return sorted(cases)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--series", type=int, default=1024)
    ap.add_argument("--samples", type=int, default=16384)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", type=pathlib.Path, default=None,
                    help="also time the main path by stage and profile it; write to this dir")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs an NVIDIA card")
    if not (SRC / "repro_torch").is_dir():
        fail(f"the port's package is missing: {SRC / 'repro_torch'}")
    sys.path.insert(0, str(SRC))
    import repro_torch.core as P
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import cone_scan as cs_mod
    from repro_torch.kernels import rans as rk

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _, build_s = sync_time(_build.build_all)
    print(f"kernels built in {build_s:.1f} s", flush=True)

    # phase 2: the main path, with the kernels' inputs recorded
    values = gateway_batch(args.series, args.samples, args.seed)
    recs = [Recorder(ops, name) for name in ("cone_scan", "rans_encode_rows", "rans_decode_rows")]
    ops.reset_launches()
    stats = main_path(P, values, dev)
    launches = dict(ops.launches)
    for rec in recs:
        rec.restore()
    print("main path: " + json.dumps({k: v for k, v in stats.items()
                                      if k not in ("codec", "blobs")}), flush=True)
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the main path")

    # phase 3: each kernel against its plain version, on the main path's inputs
    (x, eps), _ = recs[0].args
    rows = [check_cone_scan(cs_mod, x, eps, launches["cone_scan"])]
    rows += check_rans(rk, recs[1].args[0], recs[2].args, launches)
    del x, eps, recs
    torch.cuda.empty_cache()

    # phase 4: the CPU route gives the same bytes as the card
    cpu = P.ShrinkCodec(stats["codec"].config, device="cpu")
    cpu_blobs = [P.cs_to_bytes(cs) for cs in cpu.compress_batch(values[:8], TIERS,
                                                                decimals=DECIMALS)]
    check(cpu_blobs == stats["blobs"][:8], "CPU route bytes differ from the card's")
    print("cpu route: 8 series, SHRK bytes identical", flush=True)

    # phase 5: golden fixtures on the card
    print("golden: " + ", ".join(check_golden(P, dev)) + " identical", flush=True)

    if args.trace is not None:
        trace = trace_main_path(P, values, stats["codec"], dev, args.trace)
        print("trace: " + json.dumps(trace), flush=True)

    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
