"""Runner of the prefill mixes: independent prompts, one closed-loop
stream, each request one ``Model.prefill`` of [1, S] through the port,
its first token read back only once the next request's prefill is queued.

Set-up makes the weights on the card from the seed and prefills one prompt
of each length the mix uses (longest first), so every shape is warm before
the window.  ``prefill_tokens_per_s`` is the prompt tokens of the requests
whose first token reached the host in the window over the window's
seconds (from the first dispatch to the last such token).  A traced run
serves an untraced window first, which the host-clock readers
(``mfu.prefill``) read, and then the traced one, which the device readers
read: the profiler slows the host, and so the traced window's rate.

Correctness: after the windows, with the program's state freed, the
reference recomputes a sample of the finished requests (the longest among
them) in float32 from the same seed's weights and tokens: the last
position's logits and the last layer's cache at every position.  The
numbers (:func:`compare`), each compared where the cell's limits file
names it: ``logit_err``, the largest relative distance of the served
logits from the reference's (L2, over the reference's spread about its
mean), ``logit_err_median``, its median over the sampled requests,
``token_gap``, the largest amount by which the served first token's
reference logit lies below the reference's best, and ``cache_err``: each
sampled request's positions cut into ``CACHE_BLOCKS`` runs, in each the
median over its positions of |served - reference| / |reference| of the
cache row, the largest over every run of every request.  So a fault in any
stretch of any request shows, while a position whose expert choice bf16
and float32 make differently (a routing flip) does not decide it.
"""
from __future__ import annotations

import dataclasses
import random
import sys
import time

import torch

from harness import traffic, weights
from harness.common import derive_seed
from harness.main import Outcome
from harness.trace import WINDOW, events_of, profiled, span, summarize
from reference import lm

CACHE_BLOCKS = 8  # runs of positions a request's cache is judged in


@dataclasses.dataclass
class View:
    """What the per-layer readers of a prefill cell read."""
    mc: dict  # the configuration's model_config
    counted: list  # prompt lengths of the requests finished in the (untraced) window
    dispatched: list  # prompt lengths of every request traced (the window's and the one after)
    window_s: float  # host seconds of the (untraced) window
    trace: object  # harness.trace.TraceSummary, or None


class _Request:
    def __init__(self, number: int, length: int, logits_row, first, cache, ready, host):
        self.number, self.length = number, length
        self.row, self.first, self.cache = logits_row, first, cache
        self.ready, self.host = ready, host

    def token(self) -> int:
        if self.ready is None:  # the CPU: nothing in flight
            return int(self.first)
        self.ready.synchronize()
        return int(self.host)


def _issue(model, params, job, number: int, length: int, prof) -> _Request:
    mc = job.config["model_config"]
    tokens = traffic.prompt_tokens(job.seed, number, length, mc["vocab_size"], job.device)
    with span(prof, "perfbench.prefill"):
        logits, caches = model.prefill(params, {"tokens": tokens})
        row = logits[0, -1]
        first = row.argmax()
        cache = last_cache_rows(caches)
    if job.device.type != "cuda":
        return _Request(number, length, row, first, cache, None, None)
    host = torch.empty((), dtype=first.dtype, pin_memory=True)
    host.copy_(first, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record()
    return _Request(number, length, row, first, cache, ready, host)


def last_cache_rows(caches: dict) -> torch.Tensor:
    """The last layer's cache of a [1, S] prefill as rows [S, C]: MLA's
    latent and rope key, or K and V, flattened (a copy: the rest goes)."""
    if caches["tail"]:
        c, last = caches["tail"][-1], (lambda t: t)
    elif caches["groups"]:  # stacked groups: the last layer of the last stack
        c, last = caches["groups"][max(caches["groups"], key=lambda k: int(k[3:]))], (
            lambda t: t[-1])
    else:
        c, last = caches["prefix"][-1], (lambda t: t)
    c = c["self"]
    parts = [last(t) for t in ((c.c_kv, c.k_rope) if hasattr(c, "c_kv") else (c.k, c.v))]
    s = parts[0].shape[1]
    return torch.cat([t.reshape(s, -1) for t in parts], dim=1)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _window(model, params, job, sched, lengths: list, prof) -> tuple:
    """One closed-loop window of ``job.seconds``: (the requests finished in
    it, its host seconds, the request still in flight at its close)."""
    done: list[_Request] = []
    t_start = time.perf_counter()
    number, item = sched.next()
    cur = _issue(model, params, job, number, lengths[item], prof)
    while True:
        number, item = sched.next()
        nxt = _issue(model, params, job, number, lengths[item], prof)
        cur.token()
        t = time.perf_counter()
        done.append(cur)
        if t - t_start >= job.seconds:
            return done, t - t_start, nxt
        cur = nxt


def run(job) -> Outcome:
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.model import Model

    mc = job.config["model_config"]
    model = Model(ModelConfig(**mc))
    lengths = traffic.lengths(job.mix["prompt_lengths"])
    with torch.no_grad():
        t = time.perf_counter()
        params = weights.make(mc, job.seed, job.device)
        _sync(job.device)
        t_weights = time.perf_counter()
        for length in sorted(set(lengths), reverse=True):  # every shape of the mix, once
            _issue(model, params, job, f"warm-up {length}", length, None).token()
        _sync(job.device)
        setup_s = time.perf_counter() - job.t0
        print(f"set-up: {t - job.t0:.2f} s to the weights, weights {t_weights - t:.2f} s, "
              f"warm-up {time.perf_counter() - t_weights:.2f} s", file=sys.stderr)

        sched = traffic.Schedule(len(lengths), job.seed)
        finished, attempted = [], 0
        if job.trace:  # the host-clock readers' window, untraced
            done, window_s, late = _window(model, params, job, sched, lengths, None)
            late.token()
            finished += done
            attempted += len(done) + 1
        with profiled(job.trace, job.device) as prof:
            window = span(prof, WINDOW)
            window.__enter__()
            traced, traced_s, late = _window(model, params, job, sched, lengths, prof)
            window.__exit__(None, None, None)
            late.token()  # finished after the window: attempted, not counted
            _sync(job.device)
        if not job.trace:
            done, window_s = traced, traced_s
        finished += traced
        attempted += len(traced) + 1
        peak = torch.cuda.max_memory_allocated(job.device) if job.device.type == "cuda" else 0
        trace = summarize(events_of(prof)) if prof is not None else None
        del params
        checks = _check(job, mc, finished)
    counted = [r.length for r in done]
    metrics = {"prefill_tokens_per_s": sum(counted) / window_s, "setup_s": setup_s}
    view = View(mc=mc, counted=counted, dispatched=[r.length for r in traced] + [late.length],
                window_s=window_s, trace=trace)
    return Outcome(metrics=metrics, attempted=attempted, failed=0, checks=checks,
                   memory_peak_bytes=peak, view=view)


def sample(job, finished: list) -> list:
    """The finished requests the reference checks: the longest (the first
    of them) and others drawn from the seed, ``check.requests`` in all."""
    n = min(int(job.mix["check"]["requests"]), len(finished))
    longest = max(finished, key=lambda r: r.length)
    rest = [r for r in finished if r is not longest]
    return [longest] + random.Random(derive_seed(job.seed, "check")).sample(rest, n - 1)


def cache_err(served: torch.Tensor, ref: torch.Tensor) -> float:
    """Served cache rows [S, C] against the reference's: in each of
    ``CACHE_BLOCKS`` runs of positions the median of |served - ref| / |ref|
    (L2 over a row), the largest over the runs; infinite where the served
    cache does not hold every position."""
    if served.shape != ref.shape:
        return float("inf")
    got = served.float().to(ref.device)
    e = (got - ref).norm(dim=1) / ref.norm(dim=1).clamp(min=1e-30)
    return max(float(run.median()) for run in e.chunk(CACHE_BLOCKS))


def compare(served_rows: list, served_tokens: list, served_caches: list, ref_rows: list,
            ref_caches: list) -> dict:
    """The numbers a prefill cell can compare (see the module's docstring),
    and ``requests``: each request's own [logit error, cache error]."""
    per, gap = [], 0.0
    for row, tok, cache, want, want_cache in zip(served_rows, served_tokens, served_caches,
                                                 ref_rows, ref_caches):
        got = row.float().to(want.device)
        per.append([float((got - want).norm() / (want - want.mean()).norm()),
                    cache_err(cache, want_cache)])
        gap = max(gap, float(want.max() - want[tok]))
    errs = sorted(e for e, _ in per)
    mid = len(errs) // 2
    median = errs[mid] if len(errs) % 2 else (errs[mid - 1] + errs[mid]) / 2
    return {"logit_err": errs[-1], "logit_err_median": median, "token_gap": gap,
            "cache_err": max(c for _, c in per), "requests": per}


def reference_outputs(job, mc: dict, numbers: list, lengths: list, precision: str,
                      routes: list | None = None) -> tuple[list, list]:
    """The reference's last-position logits and last-layer cache rows of the
    given requests, from weights and tokens made again from the seed."""
    tree = weights.make(mc, job.seed, job.device)
    prompts = [traffic.prompt_tokens(job.seed, k, n, mc["vocab_size"], job.device)
               for k, n in zip(numbers, lengths)]
    return lm.prefill(mc, tree["embed"], weights.layers(tree), tree["ln_f"], tree["head"],
                      prompts, precision, routes)


def _check(job, mc: dict, finished: list) -> list:
    picked = sample(job, finished)
    served = [(r.row.float(), r.token(), r.cache) for r in picked]
    for r in finished:  # only the sample's outputs stay on the card
        r.row = r.first = r.cache = None
    if job.device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref, ref_caches = reference_outputs(job, mc, [r.number for r in picked],
                                        [r.length for r in picked], "float32")
    _sync(job.device)
    print(f"reference: {len(picked)} requests ({sum(r.length for r in picked)} tokens) in "
          f"{time.perf_counter() - t:.2f} s", file=sys.stderr)
    readings = compare(*zip(*served), ref, ref_caches)
    for r, (e, c) in zip(picked, readings["requests"]):
        print(f"request {r.number} ({r.length} tokens): logit_err {e!r} cache_err {c!r}",
              file=sys.stderr)
    return [(name, readings[name], limit) for name, limit in job.limits.items()]
