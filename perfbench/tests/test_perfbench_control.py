"""The control, the reference one precision below the configuration's
(fp8 products for a bf16 model, 4-bit residuals for the int8 codec), reads
well above the program on the same inputs: here at tiny sizes on the CPU,
and on the card at a cell's own size (``-m cuda``)."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import (BENCH, KV_LIMITS, KV_MIX, PREFILL_LIMITS, PREFILL_MIX, TINY_DENSE,
                      TINY_MOE)
from harness import common

CONTROL = common.load_module("tools", "control")


def test_prefill_control_reads_far_above_the_program(make_job):
    job = make_job("mistral-nemo-12b.prefill-long", TINY_DENSE, PREFILL_MIX, PREFILL_LIMITS)
    runner = common.load_module("runners", "prefill")
    program, control = CONTROL.prefill_readings(job, runner, True)
    for name in ("logit_err", "cache_err"):
        assert program[name] < PREFILL_LIMITS[name] < control[name]
        assert control[name] > 3 * program[name]


def test_a_routing_flip_moves_one_logit_and_not_the_cache(make_job):
    """On this seed bf16 and float32 route a token of the tiny MoE to other
    experts: one request's logits read several times the others', the
    reference held to the program's expert choices agrees with the program
    there, and the cache's run medians do not move."""
    job = make_job("deepseek-v2-lite-16b.prefill-long", TINY_MOE, PREFILL_MIX, PREFILL_LIMITS,
                   seed=99)
    runner = common.load_module("runners", "prefill")
    program, pinned, _ = CONTROL.prefill_readings(job, runner, True)
    flip = max(range(len(program["requests"])), key=lambda i: program["requests"][i][0])
    others = [e for i, (e, _) in enumerate(program["requests"]) if i != flip]
    assert program["requests"][flip][0] > 3 * max(others)
    assert pinned["requests"][flip][0] < 1.5 * max(others)
    assert pinned["cache_err"] == program["cache_err"] < PREFILL_LIMITS["cache_err"]


def test_kv_control_reads_far_above_the_program(make_job):
    job = make_job("mistral-nemo-12b.kv-park", TINY_DENSE, KV_MIX, KV_LIMITS)
    runner = common.load_module("runners", "kv_park")
    program, stale, control = CONTROL.kv_readings(job, runner, True, cycles=3)
    assert program["dev_max_steps"] <= KV_LIMITS["dev_max_steps"] < control["dev_max_steps"]
    assert control["dev_rms_steps"] > KV_LIMITS["dev_rms_steps"] >= program["dev_rms_steps"]
    assert stale["dev_rms_steps"] > KV_LIMITS["dev_rms_steps"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["mistral-nemo-12b.kv-park", "deepseek-v2-lite-16b.prefill-long"])
def test_control_on_the_card_at_the_cells_size(card, cell):
    run = subprocess.run([sys.executable, str(BENCH / "tools" / "control.py"), "--workload", cell,
                          "--seeds", "1", "--control-seeds", "1", "--cycles", "3"],
                         cwd=BENCH.parent, capture_output=True, text=True, timeout=900)
    assert run.returncode == 0, run.stderr[-2000:]
    rows = {r["side"]: r for r in map(json.loads, run.stdout.strip().splitlines())}
    limits = common.read_json(common.limits_file(cell))
    for name, limit in limits.items():
        assert rows["program"][name] <= limit
    assert any(rows["control"][name] > limit for name, limit in limits.items())
