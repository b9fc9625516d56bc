#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--series 1024] [--samples 16384] [--seed 0]
                          [--ragged-series 1024] [--kv-batch 4] [--trace DIR]

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
   same SHRK bytes, and so do 8 non-negative ones with zeros of both signs
   (a zero extreme takes numpy's sign in some rows of the batch).
5. golden files: ``tests/golden/golden_v4*.shrk`` decode losslessly on the
   card and re-encode byte for byte.
6. ragged gateway: ``compress_batch`` on S seeded random walks with lengths
   log-uniform over 7..30,000 plus 4 empty and 4 length-1 series, with the
   default ``best`` entropy backend; lossless decode bit-identical, every
   tier within its eps; the cone scan's masked mode against its plain
   version (torch.equal) on the first and the last bucket's inputs; 8
   series through ``device="cpu"`` give the same bytes; the backend count
   per stream and whether ``zstandard`` imports.
7. KV store at llama3-8b width (32 layers, 8 KV heads, head_dim 128, bf16;
   ``src/repro/configs/llama3_8b.py``): prefill caches of 2048 positions
   for a batch of 4, ``promote_caches`` to 8192, ``quantize_cache``,
   ``dequantize_cache``.  ``residual_quant``, ``dequant`` and ``base_fit``
   (the fit, in the reference's summation order) against their plain
   versions on the path's own inputs (torch.equal); the float32
   reconstruction within half a step of its input plus float32 rounding
   (the largest error in half-steps is printed); memory bits against
   bf16; rows whose bf16 theta/slope differ from the CPU route on a
   sample of 64-row blocks (printed, not hidden).

Each path's launch counts are zeroed just before it and read just after;
each kernel the path runs must have run.
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

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s; FP64 and FP32
# outside the tensor cores; INT32 as 132 SMs x 64 INT32 lanes x 1.98 GHz boost (one
# operation per lane-cycle).
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12
F32_OPS_PER_S = 67e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
TIERS = [1e-1, 1e-2, 1e-3, 0.0]
DECIMALS = 4
GOLDEN_N, GOLDEN_DECIMALS = 1536, 3  # tests/golden/regen.py
# llama3-8b's decode KV cache (src/repro/configs/llama3_8b.py): layers,
# KV heads, head_dim; prefill and decode buffer lengths
KV_LAYERS, KV_HEADS, KV_DIM = 32, 8, 128
KV_PREFILL, KV_MAX_SEQ = 2048, 8192
KV_CHUNK_ROWS = 1 << 20  # rows per pass of the plain versions' comparisons


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


def ragged_walks(series: int, seed: int) -> list[np.ndarray]:
    """The README's ragged gateway traffic: random walks of log-uniform
    lengths over 7..30,000, plus 4 empty and 4 length-1 series."""
    rng = np.random.default_rng(seed + 1)
    lengths = np.exp(rng.uniform(np.log(7), np.log(30_000), series)).astype(np.int64)
    lengths = np.concatenate([lengths, [0] * 4, [1] * 4])
    return [np.round(np.cumsum(rng.standard_normal(n)) * 0.1, 4) for n in lengths]


def ragged_path(P, E, ops, cs_mod, arrs: list[np.ndarray], dev) -> dict:
    """Phase 6: the ragged gateway batch through the default backend."""
    allv = np.concatenate(arrs)
    codec = P.ShrinkCodec.from_fraction(allv, frac=0.05, device=dev)
    check(codec.backend == "best", f"default backend is {codec.backend!r}, not 'best'")
    scans = []
    orig = ops.cone_scan

    def recording_scan(*args):
        scans.append(args)
        return orig(*args)

    ops.cone_scan = recording_scan
    try:
        ops.reset_launches()
        css, t_compress = sync_time(lambda: codec.compress_batch(arrs, TIERS, decimals=DECIMALS))
        blobs = [P.cs_to_bytes(cs) for cs in css]
        parsed = [P.cs_from_bytes(b) for b in blobs]
        outs, t_decode = sync_time(lambda: [codec.decompress_at(cs, 0.0) for cs in parsed])
        for i, cs in enumerate(parsed):
            v = torch.as_tensor(arrs[i], device=dev)
            check(torch.equal(outs[i], v), f"ragged series {i}: lossless decode differs")
            if not v.numel():
                continue
            dec = P.ProgressiveDecoder(cs, dev)
            for k, eps in enumerate(TIERS):
                err = float((dec.prefix(k) - v).abs().max())
                check(err <= tier_bound(eps, v), f"ragged series {i} tier {eps}: error {err}")
        launches = dict(ops.launches)
    finally:
        ops.cone_scan = orig
    check(launches["cone_scan"] == len(scans) > 0, "the ragged path ran no masked cone scan")
    backends: dict[str, int] = {}
    for cs in parsed:
        for layer in cs.pyramid.layers:
            if layer.payload:
                name = E.backend_name(layer.payload[0])
                backends[name] = backends.get(name, 0) + 1
    if backends.get("rans"):
        for name in ("rans_encode", "rans_decode"):
            check(launches[name] > 0, f"rANS streams but kernel {name} was not launched")
    # the masked scan against its plain version on the path's own inputs
    masked = {}
    for which, (x, eps, ln) in (("first", scans[0]), ("last", scans[-1])):
        check(ln is not None, "the ragged path's scan ran without lengths")
        got = cs_mod.cone_scan_cuda(x, eps, ln)
        want, plain_s = sync_time(lambda: cs_mod.cone_scan_plain(x, eps, ln))
        err = max_abs_err(got, want)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"masked cone_scan ({which} bucket) differs from its plain version (max err {err})")
        masked[which] = {"shape": list(x.shape), "max_abs_err": err,
                         "ms": event_ms(lambda: cs_mod.cone_scan_cuda(x, eps, ln), 5),
                         "plain_ms": plain_s * 1e3}
    # 8 series through the CPU route: the same bytes
    ns = np.array([a.size for a in arrs])
    order = np.argsort(ns, kind="stable")
    pick = sorted({int(i) for i in (order[0], order[4], order[8], order[9],
                                    order[len(order) // 2], order[-2], order[-1], 17)})[:8]
    cpu = P.ShrinkCodec(codec.config, device="cpu")
    cpu_blobs = [P.cs_to_bytes(cs) for cs in cpu.compress_batch([arrs[i] for i in pick], TIERS,
                                                                decimals=DECIMALS)]
    check(cpu_blobs == [blobs[i] for i in pick], "ragged: CPU route bytes differ from the card's")
    archive = sum(len(b) for b in blobs)
    return {
        "series": len(arrs), "samples": int(ns.sum()), "min_len": int(ns.min()),
        "max_len": int(ns.max()), "archive_bytes": archive,
        "compression_ratio": P.BYTES_PER_ROW * int(ns.sum()) / archive,
        "compress_s": t_compress, "decompress_at_lossless_s": t_decode,
        "launches": launches, "buckets": len(scans), "backend_streams": backends,
        "zstandard_importable": "zstd" in E.available_backends(),
        "cpu_route_series": pick, "masked_scan": masked,
    }


def kv_caches(P_layers, batch: int, seed: int, dev):
    """Seeded prefill caches of llama3-8b's width in the stacked ``groups``
    form: K and V [32, B, 2048, 8, 128] bf16, normal values with a
    log-normal scale per (KV head, channel), some channels large as in
    real K caches; kpos [32, B, 2048]."""
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (KV_LAYERS, batch, KV_PREFILL, KV_HEADS, KV_DIM)
    out = []
    for spread in (1.0, 0.5):  # K's channels spread wider than V's
        scale = torch.exp(torch.randn((KV_HEADS, KV_DIM), device=dev, generator=g) * spread)
        out.append((torch.randn(shape, device=dev, generator=g) * scale).to(torch.bfloat16))
    kpos = torch.arange(KV_PREFILL, dtype=torch.int32, device=dev).expand(
        KV_LAYERS, batch, KV_PREFILL).contiguous()
    return {"prefix": [], "groups": {"pos0": {"self": P_layers.AttnCache(out[0], out[1], kpos)}},
            "tail": []}


def chunked_equal(kernel_out, plain_fn, rows: int) -> tuple[bool, float, float]:
    """Compare kernel outputs [M, ...] with the plain version, run over row
    chunks (the same work as one call, in bounded memory); returns (equal,
    max |kernel - plain|, seconds of the plain passes)."""
    ok, worst, plain_s = True, 0.0, 0.0
    for a in range(0, rows, KV_CHUNK_ROWS):
        want, dt = sync_time(lambda: plain_fn(a, a + KV_CHUNK_ROWS))
        plain_s += dt
        got = [t[a:a + KV_CHUNK_ROWS] for t in kernel_out]
        ok = ok and all(torch.equal(x, y) for x, y in zip(got, want))
        worst = max(worst, max_abs_err(got, want))
        del want, got
    return ok, worst, plain_s


def kv_path(T, KV, P_layers, ops, RQ, DQ, BF, batch: int, seed: int, dev) -> tuple[dict, list]:
    """Phase 7: the KV store at llama3-8b width; returns the stats and the
    three kernels' rows."""
    caches = kv_caches(P_layers, batch, seed, dev)
    prefill = caches["groups"]["pos0"]["self"]
    recs = [Recorder(ops, "residual_quant"), Recorder(ops, "dequant"), Recorder(ops, "base_fit")]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    try:
        promoted, t_promote = sync_time(lambda: KV.promote_caches(caches, KV_MAX_SEQ))
        cache = promoted["groups"]["pos0"]["self"]
        del caches, prefill
        qkv, t_quant = sync_time(lambda: KV.quantize_cache(cache))
        back, t_dequant = sync_time(lambda: KV.dequantize_cache(qkv))
        launches = dict(ops.launches)
    finally:
        for rec in recs:
            rec.restore()
    for name in ("residual_quant", "dequant", "base_fit"):
        check(launches[name] > 0, f"kernel {name} was not launched on the KV-store path")
    peak = torch.cuda.max_memory_allocated()
    check(tuple(cache.k.shape) == (KV_LAYERS, batch, KV_MAX_SEQ, KV_HEADS, KV_DIM),
          f"promoted K has shape {tuple(cache.k.shape)}")
    check(int(cache.kpos[..., KV_PREFILL:].max()) == -1, "promoted kpos slots are not empty")
    check(back.k.dtype == torch.bfloat16 and back.k.shape == cache.k.shape, "dequantized K")
    check(torch.equal(back.kpos, cache.kpos), "dequantized kpos differs")
    bits = qkv.memory_bits()
    bf16_bits = (cache.k.numel() + cache.v.numel()) * 16 + cache.kpos.numel() * 32
    del back
    # residual_quant against its plain version, on the path's own inputs (K)
    (xb, theta, slope, step), kw = recs[0].args
    m = xb.shape[0]
    got = RQ.residual_quant_cuda(xb, theta, slope, step, **kw)
    check(torch.equal(got[0], qkv.k.q), "residual_quant rerun differs from the path's q")
    ok, err_rq, plain_rq = chunked_equal(got, lambda a, b: RQ.residual_quant_plain(
        xb[a:b], theta[a:b], slope[a:b], step[a:b], **kw), m)
    check(ok, f"residual_quant kernel differs from its plain version (max err {err_rq})")
    del got
    ms_rq = event_ms(lambda: RQ.residual_quant_cuda(xb, theta, slope, step, **kw), 5)
    # dequant against its plain version, on the path's own inputs (K)
    (dq, dth, dsl, dst), _ = recs[1].args
    out = DQ.dequant_cuda(dq, dth, dsl, dst)
    ok, err_dq, plain_dq = chunked_equal([out], lambda a, b: [DQ.dequant_plain(
        dq[a:b], dth[a:b], dsl[a:b], dst[a:b])], m)
    check(ok, f"dequant kernel differs from its plain version (max err {err_dq})")
    ms_dq = event_ms(lambda: DQ.dequant_cuda(dq, dth, dsl, dst), 5)
    # base_fit against its plain version, on the path's own input (K's
    # blocks); float32 bits, so the signs of zeros count too
    (fxb,), _ = recs[2].args
    check(fxb.data_ptr() == xb.data_ptr(), "base_fit's recorded input is not K's blocks")
    fit = BF.base_fit_cuda(xb)
    check(torch.equal(fit[1].to(torch.bfloat16), qkv.k.slope.reshape(-1)),
          "base_fit rerun differs from the path's slope")
    ok, err_fit, plain_fit = chunked_equal(
        [t.view(torch.int32) for t in fit],
        lambda a, b: [t.view(torch.int32) for t in BF.base_fit_plain(xb[a:b])], m)
    check(ok, f"base_fit kernel differs from its plain version (max bit diff {err_fit})")
    del fit
    ms_fit = event_ms(lambda: BF.base_fit_cuda(xb), 5)
    # the float32 reconstruction is within half a step of each input
    # element, plus float32 rounding: r = x - pred, q * step, the
    # reciprocal and x_hat itself each round by at most half an ulp of a
    # value no larger than qmax * step or |x| (four half-ulps: 2**-21)
    ratio, worst = 0.0, 0.0
    qmax = kw["qmax"]
    for a in range(0, m, KV_CHUNK_ROWS):
        b = a + KV_CHUNK_ROWS
        d = (out[a:b] - xb[a:b]).abs()
        ratio = max(ratio, float((d / (0.5 * step[a:b])).max()))
        bound = 0.5 * step[a:b] + 2.0**-21 * (qmax * step[a:b] + xb[a:b].abs())
        worst = max(worst, float((d / bound).max()))
    check(worst <= 1.0, f"KV reconstruction error {worst} of its bound ({ratio} half-steps)")
    del out
    # bf16 theta/slope of the card against the CPU route, on 64-row blocks
    starts = torch.linspace(0, m - 64, 64).long().div(8, rounding_mode="floor").mul(8).tolist()
    rows = torch.cat([torch.arange(a, a + 64) for a in starts]).to(dev)
    th_c, sl_c = T.linear_base_fit(xb[rows].cpu())
    differ = int(((th_c.to(torch.bfloat16) != qkv.k.theta[rows].cpu())
                  | (sl_c.to(torch.bfloat16) != qkv.k.slope[rows].cpu())).sum())
    # stage times of quantize_cache's stages on the same inputs
    (th_f, sl_f), fit_s = sync_time(lambda: T.linear_base_fit(xb))
    _, step_s = sync_time(lambda: T._default_step(xb, th_f, sl_f, qmax))
    del th_f, sl_f
    n_el, n_rows = xb.numel(), xb.shape[0]
    rq_bytes = n_el * (4 + 1 + 4) + n_rows * 12
    dq_bytes = n_el * (1 + 4) + n_rows * 12
    rq_ops, dq_ops = 10 * n_el, 4 * n_el
    fit_bytes, fit_ops = n_el * 4 + n_rows * 8, 3 * n_el  # x read; theta, slope written
    rows_out = [
        kernel_row("residual_quant", "src/repro_torch/kernels/csrc/residual_quant.cu",
                   "src/repro/kernels/residual_quant.py:38", launches, err_rq, ms_rq,
                   plain_rq * 1e3, rq_bytes, rq_ops, F32_OPS_PER_S, [m, xb.shape[1]]),
        kernel_row("dequant", "src/repro_torch/kernels/csrc/dequant.cu",
                   "src/repro/kernels/dequant.py:20", launches, err_dq, ms_dq,
                   plain_dq * 1e3, dq_bytes, dq_ops, F32_OPS_PER_S, [m, xb.shape[1]]),
        kernel_row("base_fit", "src/repro_torch/kernels/csrc/base_fit.cu",
                   "src/repro/core/jaxshrink.py:66", launches, err_fit, ms_fit,
                   plain_fit * 1e3, fit_bytes, fit_ops, F32_OPS_PER_S, [m, xb.shape[1]]),
    ]
    stats = {
        "shape": list(cache.k.shape), "blocks_per_tensor": m,
        "promote_s": t_promote, "quantize_cache_s": t_quant, "dequantize_cache_s": t_dequant,
        "fit_s_one_tensor": fit_s, "default_step_s_one_tensor": step_s,
        "memory_bits": bits, "bf16_bits": bf16_bits, "memory_ratio": bf16_bits / bits,
        "max_err_over_half_step": ratio, "max_err_over_bound": worst,
        "sampled_rows": len(rows),
        "bf16_theta_slope_rows_differing_from_cpu": differ,
        "max_memory_allocated_bytes": peak, "launches": launches,
    }
    return stats, rows_out


def kernel_row(name, source, replaces, launches, err, ms, plain_ms, nbytes, nops, peak, shape):
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, nops / peak
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches[name], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": 1e3 * max(by_bytes, by_ops),
        "bound_by": "bytes" if by_bytes >= by_ops else "operations",
        "library_ms": None, "shape": shape,
    }


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
    codec = P.ShrinkCodec(P.ShrinkConfig(eps_b=0.05 * rng, lam=1e-3), backend="rans", device=dev)
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
    ap.add_argument("--ragged-series", type=int, default=1024)
    ap.add_argument("--kv-batch", type=int, default=4)
    ap.add_argument("--trace", type=pathlib.Path, default=None,
                    help="also time the main path by stage and profile it; write to this dir")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs an NVIDIA card")
    if not (SRC / "repro_torch").is_dir():
        fail(f"the port's package is missing: {SRC / 'repro_torch'}")
    sys.path.insert(0, str(SRC))
    import repro_torch.core as P
    from repro_torch.core import entropy as E
    from repro_torch.core import tensorshrink as T
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import base_fit as BF
    from repro_torch.kernels import cone_scan as cs_mod
    from repro_torch.kernels import dequant as DQ
    from repro_torch.kernels import rans as rk
    from repro_torch.kernels import residual_quant as RQ
    from repro_torch.models import layers as P_layers
    from repro_torch.serving import kvcache as KV

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
    for name in ("cone_scan", "rans_encode", "rans_decode"):
        check(launches[name] > 0, f"kernel {name} was not launched on the main path")

    # phase 3: each kernel against its plain version, on the main path's inputs
    (x, eps, _lengths), _ = recs[0].args
    rows = [check_cone_scan(cs_mod, x, eps, launches["cone_scan"])]
    rows += check_rans(rk, recs[1].args[0], recs[2].args, launches)
    del x, eps, recs
    torch.cuda.empty_cache()

    # phase 4: the CPU route gives the same bytes as the card
    cpu = P.ShrinkCodec(stats["codec"].config, backend="rans", device="cpu")
    cpu_blobs = [P.cs_to_bytes(cs) for cs in cpu.compress_batch(values[:8], TIERS,
                                                                decimals=DECIMALS)]
    check(cpu_blobs == stats["blobs"][:8], "CPU route bytes differ from the card's")
    dry = np.where(values[8:16] > values[8:16, :1], np.round(values[8:16] - values[8:16, :1], 4),
                   -0.0)
    dry[::2] = np.where(np.arange(dry.shape[1]) % 3 == 0, 0.0, dry[::2])
    card_dry = [P.cs_to_bytes(cs) for cs in stats["codec"].compress_batch(dry, TIERS, DECIMALS)]
    check(card_dry == [P.cs_to_bytes(cs) for cs in cpu.compress_batch(dry, TIERS, DECIMALS)],
          "non-negative rows with zeros: CPU route bytes differ from the card's")
    print("cpu route: 8 series and 8 non-negative ones with zeros, SHRK bytes identical",
          flush=True)

    # phase 5: golden fixtures on the card
    print("golden: " + ", ".join(check_golden(P, dev)) + " identical", flush=True)

    # phase 6: the ragged gateway through the default backend
    ragged = ragged_path(P, E, ops, cs_mod, ragged_walks(args.ragged_series, args.seed), dev)
    rows[0]["launches_by_path"] = {"gateway": launches["cone_scan"],
                                   "ragged": ragged["launches"]["cone_scan"]}
    rows[0]["masked"] = ragged["masked_scan"]
    print("ragged: " + json.dumps(ragged), flush=True)
    torch.cuda.empty_cache()

    # phase 7: the KV store at llama3-8b width
    kv, kv_rows = kv_path(T, KV, P_layers, ops, RQ, DQ, BF, args.kv_batch, args.seed, dev)
    rows += kv_rows
    print("kv store: " + json.dumps(kv), flush=True)
    torch.cuda.empty_cache()

    if args.trace is not None:
        trace = trace_main_path(P, values, stats["codec"], dev, args.trace)
        print("trace: " + json.dumps(trace), flush=True)

    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
