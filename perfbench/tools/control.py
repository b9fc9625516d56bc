"""The readings that a cell's limits are set from, on the card at the
cell's own size: the numbers that a run compares, for the program over
many seeds and for the control (the reference one precision below the
configuration's: fp8 products for a bf16 model, 4-bit residuals for the
int8 codec) over a few, all in one process.

    python3 perfbench/tools/control.py --workload <cell> --seeds <n> --control-seeds <m> \
        [--cycles <c>] [--first-seed <s>]

A prefill cell: each seed prefills one sweep of the mix's prompts in the
window's order through the port, picks the requests a run would check
(``runners/prefill.sample``), and compares them, and the control's outputs
on the same prompts, with the float32 reference; a MoE model's also with
the reference held to the program's expert choices (``pinned``).  A KV park cell: each
seed parks the sessions a run would check, restores and parks them
``--cycles`` times through the port, and compares the restores after 2
and after ``--cycles`` round trips, those of a park that hands back its
first state (a fault), and the 4-bit reference codec's, with the 8-bit
reference.  Prints one JSON
line a seed and side.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from harness import common, main, traffic  # noqa: E402


def prefill_readings(job, runner, with_control: bool) -> list:
    """The program's numbers and each request's own; of a MoE model also
    ``pinned``: the same served outputs against the reference made to take
    the experts the program's router chose (a witness of routing flips:
    where bf16 and float32 pick another expert for a token, this reference
    follows the program); and the control's."""
    import torch
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import layers
    from repro_torch.models.model import Model

    mc = job.config["model_config"]
    model = Model(ModelConfig(**mc))
    lengths = traffic.lengths(job.mix["prompt_lengths"])
    sched = traffic.Schedule(len(lengths), job.seed)
    chosen, routes = [], {}
    real_route = layers._route

    def route(p, xt, cfg):
        out = real_route(p, xt, cfg)
        chosen.append(out[2])
        return out

    with torch.no_grad():
        params = runner.weights.make(mc, job.seed, job.device)
        served = []
        layers._route = route
        try:
            for _ in lengths:
                number, item = sched.next()
                chosen.clear()
                r = runner._issue(model, params, job, number, lengths[item], None)
                r.token()
                routes[number] = list(chosen)
                served.append(r)
        finally:
            layers._route = real_route
        del params
        torch.cuda.empty_cache()
        picked = runner.sample(job, served)
        numbers, lens = [r.number for r in picked], [r.length for r in picked]
        mine = ([r.row for r in picked], [r.token() for r in picked], [r.cache for r in picked])
        ref = runner.reference_outputs(job, mc, numbers, lens, "float32")
        out = [{"side": "program", "lengths": lens, **runner.compare(*mine, *ref)}]
        if mc.get("n_experts"):
            pinned = runner.reference_outputs(job, mc, numbers, lens, "float32",
                                              [routes[n] for n in numbers])
            out.append({"side": "pinned", "lengths": lens, **runner.compare(*mine, *pinned)})
        if with_control:
            logits, caches = runner.reference_outputs(job, mc, numbers, lens, "fp8")
            out.append({"side": "control", "lengths": lens,
                        **runner.compare(logits, [int(c.argmax()) for c in logits], caches,
                                         *ref)})
    return out


def kv_readings(job, runner, with_control: bool, cycles: int) -> list:
    """``dev_max_steps`` after 2 round trips (a run's first restores) and
    ``dev_rms_steps`` after ``cycles`` (its last ones), for the program,
    for a park that hands back its first state unchanged (``stale``), and
    for the control."""
    import torch
    from repro_torch.core.tensorshrink import TensorCodecConfig
    from repro_torch.models.layers import AttnCache
    from repro_torch.serving.kvcache import dequantize_cache, quantize_cache

    from reference import kvcodec

    codec = TensorCodecConfig(**job.mix["codec"])
    lengths = traffic.lengths(job.mix["session_lengths"])
    layers = job.config["model_config"]["n_layers"]
    sides = ("program", "stale", "control") if with_control else ("program", "stale")
    rows = {s: {"dev_max_steps": 0.0, "dev_rms_steps": 0.0} for s in sides}

    def note(side, name, x, want, steps):
        col = 0 if name == "dev_max_steps" else 1
        rows[side][name] = max(rows[side][name],
                               kvcodec.deviation(x, want, steps, codec.block)[col])

    with torch.no_grad():
        for j in sorted(runner.sample(job.seed, lengths, int(job.mix["check"]["sessions"]))):
            n = lengths[j]
            k, v = runner.session_cache(job, j, n)
            kpos = torch.arange(n, dtype=torch.int32, device=job.device).expand(
                layers, 1, n).contiguous()
            parked = quantize_cache(AttnCache(k, v, kpos), codec)
            once = dequantize_cache(parked, codec)
            got = {}
            for c in range(2, cycles + 1):
                parked = quantize_cache(dequantize_cache(parked, codec), codec)
                if c in (2, cycles):
                    got[c] = dequantize_cache(parked, codec)
            for t, orig in enumerate((k, v)):
                for c, name in ((2, "dev_max_steps"), (cycles, "dev_rms_steps")):
                    want, steps = kvcodec.chain(orig, c, codec.block, codec.bits)
                    note("program", name, (got[c].k, got[c].v)[t], want, steps)
                    note("stale", name, (once.k, once.v)[t], want, steps)
                    if with_control:
                        note("control", name, kvcodec.chain(orig, c, codec.block, 4)[0], want,
                             steps)
                    del want, steps
            del k, v, parked, got, once
    return [{"side": s, **rows[s]} for s in sides]


def main_(argv) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--cycles", type=int, default=12)
    p.add_argument("--first-seed", type=int, default=2_200_000_000)
    args = p.parse_args(argv)
    base = main.prepare(["--workload", args.workload, "--seed", "0", "--seconds", "0"])
    runner = common.load_module("runners", base.mix["runner"])
    for i in range(args.seeds):
        base.seed = args.first_seed + 7919 * i
        t = time.perf_counter()
        control = i < args.control_seeds
        if base.mix["runner"] == "prefill":
            rows = prefill_readings(base, runner, control)
        else:
            rows = kv_readings(base, runner, control, args.cycles)
        for row in rows:
            print(json.dumps({"workload": args.workload, "seed": base.seed, **row,
                              "seconds": round(time.perf_counter() - t, 2)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main_(sys.argv[1:]))
