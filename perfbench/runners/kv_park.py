"""Runner of the KV park mixes: the port's KV store under memory pressure.

Set-up makes every session's bf16 cache on the card from the seed (the
configuration's layers, KV heads and head dim, in the port's stacked
``AttnCache`` layout) and parks it with ``serving.kvcache.quantize_cache``,
then restores and parks each once (every shape warm).  In the window each
request is a session's next turn: ``dequantize_cache`` restores its bf16
cache (timed on the card with CUDA events, from the first operation of the
restore to its last: ``kv_restore_p95_ms``), then ``quantize_cache`` parks
it again.  Sessions come in seeded sweeps, each once a sweep; closed loop.
``kv_park_tokens_per_s`` is the cached tokens restored and parked again
over the window's seconds (the last park included).

Correctness: for a sample of sessions (the longest among them) the run
keeps two of the states the window parked: each session's state before
its first restore in the window, and its state after the window's last
park.  After the window, with the rest of the pool freed, the port's
``dequantize_cache`` reads each back, and the reference codec applies its
round trip to the seed's cache as many times as the state had been
parked; the run compares the two in units of the reference's step of each
block: ``dev_max_steps``, the largest over the first states (two round
trips: the program's and the reference's roundings part in a few blocks,
and a part compounds over later trips), and ``dev_rms_steps``, the root
mean square over the last states (every trip of the window).  Each is
compared where the cell's limits file names it.  The kept states are the
parked ones, about half a bf16 cache each: keeping the bf16 restores of
the sample took up to 23 GB beside the pool, and on seeds that drew long
sessions the allocator then stalled the window by up to 40%.
"""
from __future__ import annotations

import dataclasses
import random
import sys
import time

import torch

from harness import traffic
from harness.common import derive_seed
from harness.main import Outcome
from harness.trace import WINDOW, events_of, profiled, span, summarize
from reference import kvcodec


@dataclasses.dataclass
class View:
    """What the per-layer readers of a KV park cell read."""
    elements: list  # elements of K and of V of each session restored and parked in the trace
    block: int  # the codec's elements a block
    window_s: float
    trace: object


def nearest_rank(values: list, percent: int) -> float:
    """The ``percent``-th percentile of ``values`` by the nearest rank."""
    s = sorted(values)
    return s[max(0, -(-percent * len(s) // 100) - 1)]


class _Timer:
    """A restore's time on the card (CUDA events), or on the host clock."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.a, self.b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)

    def start(self):
        if self.cuda:
            self.a.record()
        else:
            self.t = time.perf_counter()

    def stop_ms(self) -> float:
        if self.cuda:
            self.b.record()
            self.b.synchronize()
            return self.a.elapsed_time(self.b)
        return (time.perf_counter() - self.t) * 1e3


def _shape(mc: dict) -> tuple[int, int, int]:
    return mc["n_layers"], mc["n_kv_heads"], mc.get("head_dim") or mc["d_model"] // mc["n_heads"]


def session_cache(job, j: int, length: int):
    layers, kvh, hd = _shape(job.config["model_config"])
    return traffic.kv_cache(job.seed, j, length, layers, kvh, hd, job.mix["cache"], job.device)


def run(job) -> Outcome:
    from repro_torch.core.tensorshrink import TensorCodecConfig
    from repro_torch.models.layers import AttnCache
    from repro_torch.serving.kvcache import dequantize_cache, quantize_cache

    codec = TensorCodecConfig(**job.mix["codec"])
    lengths = traffic.lengths(job.mix["session_lengths"])
    layers = job.config["model_config"]["n_layers"]
    picked = sample(job.seed, lengths, int(job.mix["check"]["sessions"]))
    parked, parks = [], [0] * len(lengths)
    with torch.no_grad():
        t = time.perf_counter()
        for j, n in enumerate(lengths):
            k, v = session_cache(job, j, n)
            kpos = torch.arange(n, dtype=torch.int32, device=job.device).expand(
                layers, 1, n).contiguous()
            parked.append(quantize_cache(AttnCache(k, v, kpos), codec))
            parks[j] = 1
            del k, v
        _sync(job.device)
        t_pool = time.perf_counter()
        for j in range(len(lengths)):  # one restore and park of every shape
            parked[j] = quantize_cache(dequantize_cache(parked[j], codec), codec)
            parks[j] += 1
        _sync(job.device)
        setup_s = time.perf_counter() - job.t0
        print(f"set-up: {t - job.t0:.2f} s to the pool, pool {t_pool - t:.2f} s, "
              f"warm-up {time.perf_counter() - t_pool:.2f} s", file=sys.stderr)

        sched = traffic.Schedule(len(lengths), job.seed)
        timer = _Timer(job.device)
        restore_ms, done, first = [], [], {}
        with profiled(job.trace, job.device) as prof:
            with span(prof, WINDOW):
                t_start = time.perf_counter()
                while time.perf_counter() - t_start < job.seconds:
                    _, j = sched.next()
                    if j in picked and j not in first:  # the state its first restore reads
                        first[j] = (parked[j], parks[j])
                    timer.start()
                    with span(prof, "perfbench.restore"):
                        cache = dequantize_cache(parked[j], codec)
                    restore_ms.append(timer.stop_ms())
                    with span(prof, "perfbench.park"):
                        parked[j] = quantize_cache(cache, codec)
                    parks[j] += 1
                    done.append(j)
                    del cache
                _sync(job.device)
                window_s = time.perf_counter() - t_start
        peak = torch.cuda.max_memory_allocated(job.device) if job.device.type == "cuda" else 0
        trace = summarize(events_of(prof)) if prof is not None else None
        last = {j: (parked[j], parks[j]) for j in first}  # after the window's last park
        del parked
        checks = _check(job, lengths, picked, first, last, codec)
    tokens = sum(lengths[j] for j in done)
    metrics = {"kv_park_tokens_per_s": tokens / window_s,
               "kv_restore_p95_ms": nearest_rank(restore_ms, 95), "setup_s": setup_s}
    per_token = layers * _shape(job.config["model_config"])[1] * _shape(
        job.config["model_config"])[2]
    view = View(elements=[lengths[j] * per_token for j in done], block=codec.block,
                window_s=window_s, trace=trace)
    return Outcome(metrics=metrics, attempted=len(done), failed=0, checks=checks,
                   memory_peak_bytes=peak, view=view)


def sample(seed: int, lengths: list, n: int) -> set:
    """The sessions whose restores are checked: the longest and others
    drawn from the seed, ``n`` in all."""
    longest = max(range(len(lengths)), key=lambda j: lengths[j])
    rest = [j for j in range(len(lengths)) if j != longest]
    n = min(n, len(lengths))
    return {longest, *random.Random(derive_seed(seed, "check")).sample(rest, n - 1)}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _check(job, lengths: list, picked: set, first: dict, last: dict, codec) -> list:
    from repro_torch.serving.kvcache import dequantize_cache

    if job.device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    readings = {"dev_max_steps": 0.0, "dev_rms_steps": 0.0}
    for name, kept, col in (("dev_max_steps", first, 0), ("dev_rms_steps", last, 1)):
        for j, (state, cycles) in sorted(kept.items()):
            cache = dequantize_cache(state, codec)
            for got, orig in zip((cache.k, cache.v), session_cache(job, j, lengths[j])):
                want, steps = kvcodec.chain(orig, cycles, codec.block, codec.bits)
                dev = kvcodec.deviation(got, want, steps, codec.block)[col]
                readings[name] = max(readings[name], dev)
                del want, steps
        if set(kept) != picked:  # a sampled session never came back in the window
            readings[name] = 1e300
    print(f"reference: {len(picked)} sessions in {time.perf_counter() - t:.2f} s", file=sys.stderr)
    return [(name, readings[name], limit) for name, limit in job.limits.items()]
