"""A run with its timed path broken underneath comes out not correct: the
runners' own path on the CPU at tiny sizes (without the harness's look for
a card), once sound and once for each fault the cell can have."""
from __future__ import annotations

import pytest

from conftest import KV_LIMITS, KV_MIX, PREFILL_LIMITS, PREFILL_MIX, TINY_DENSE, TINY_MOE
from harness import main

NO_CHOICE_MOE = {**TINY_MOE, "top_k": TINY_MOE["n_experts"], "capacity_factor": 8.0}
DENSE_CELL = "mistral-nemo-12b.prefill-long"
MOE_CELL = "deepseek-v2-lite-16b.prefill-long"
KV_CELL = "mistral-nemo-12b.kv-park"


def _correct(make_job, cell, mc, mix, limits) -> bool:
    return main.execute(make_job(cell, mc, mix, limits))["correct"]


def _altered_token(monkeypatch):
    from repro_torch.models.model import Model

    real = Model.prefill

    def prefill(self, params, batch):
        logits, caches = real(self, params, batch)
        logits = logits.clone()
        top = logits[0, -1].argmax()
        logits[0, -1, top] -= 100.0  # the served token and its logit changed
        return logits, caches

    monkeypatch.setattr(Model, "prefill", prefill)


def _half_prompt(monkeypatch):
    from repro_torch.models.model import Model

    real = Model.prefill

    def prefill(self, params, batch):  # half of the request's rows left out
        tokens = batch["tokens"]
        return real(self, params, {"tokens": tokens[:, tokens.shape[1] // 2:]})

    monkeypatch.setattr(Model, "prefill", prefill)


def _block_unchanged(monkeypatch):
    from repro_torch.models import transformer

    real = transformer.block_apply
    calls = {"n": 0}

    def block_apply(p, x, cfg, kind, **kw):
        calls["n"] += 1
        y, cache, aux = real(p, x, cfg, kind, **kw)
        if calls["n"] % cfg.n_layers == 0:  # each forward's last block returns its input
            return x, cache, aux
        return y, cache, aux

    monkeypatch.setattr(transformer, "block_apply", block_apply)


def _late_positions_altered(monkeypatch):
    from repro_torch.models import transformer

    real = transformer.block_apply
    calls = {"n": 0}

    def block_apply(p, x, cfg, kind, **kw):
        calls["n"] += 1
        if calls["n"] % cfg.n_layers == 0:  # the last block's input, in its last quarter
            x = x.clone()
            x[:, 3 * x.shape[1] // 4:-1] *= -1
        return real(p, x, cfg, kind, **kw)

    monkeypatch.setattr(transformer, "block_apply", block_apply)


def _experts_left_out(monkeypatch):
    from repro_torch.models import layers

    def experts(p, xt, cfg, expert_idx, gate_vals, first, count):
        return xt * 0  # the routed experts' exchange left out: shared experts only

    monkeypatch.setattr(layers, "_moe_experts", experts)


@pytest.mark.parametrize("mc,cell", [(TINY_DENSE, DENSE_CELL), (NO_CHOICE_MOE, MOE_CELL)],
                         ids=["dense", "mla_moe"])
def test_sound_prefill_is_correct(make_job, mc, cell):
    assert _correct(make_job, cell, mc, PREFILL_MIX, PREFILL_LIMITS)


@pytest.mark.parametrize("fault", [_altered_token, _half_prompt, _block_unchanged],
                         ids=["token_altered", "half_the_rows_left_out", "block_unchanged"])
@pytest.mark.parametrize("mc,cell", [(TINY_DENSE, DENSE_CELL), (NO_CHOICE_MOE, MOE_CELL)],
                         ids=["dense", "mla_moe"])
def test_broken_prefill_is_not_correct(make_job, monkeypatch, mc, cell, fault):
    fault(monkeypatch)
    assert not _correct(make_job, cell, mc, PREFILL_MIX, PREFILL_LIMITS)


@pytest.mark.parametrize("mc,cell", [(TINY_DENSE, DENSE_CELL), (NO_CHOICE_MOE, MOE_CELL)],
                         ids=["dense", "mla_moe"])
def test_late_positions_altered_show_in_the_cache(make_job, monkeypatch, mc, cell):
    _late_positions_altered(monkeypatch)
    assert not _correct(make_job, cell, mc, PREFILL_MIX, {"cache_err": PREFILL_LIMITS["cache_err"]})


def test_traced_run_serves_an_untraced_window_first(make_job):
    job = make_job(DENSE_CELL, TINY_DENSE, PREFILL_MIX, PREFILL_LIMITS, seconds=0.3, trace=True)
    result = main.execute(job)
    assert result["correct"] and "mfu.prefill" in result["metrics"]
    assert result["attempted"] >= 4  # two windows, each with its request in flight at the close


def test_moe_without_its_experts_is_not_correct(make_job, monkeypatch):
    _experts_left_out(monkeypatch)
    assert not _correct(make_job, MOE_CELL, NO_CHOICE_MOE, PREFILL_MIX, PREFILL_LIMITS)


def test_sound_kv_park_is_correct(make_job):
    assert _correct(make_job, KV_CELL, TINY_DENSE, KV_MIX, KV_LIMITS)


def _restore_altered(monkeypatch):
    from repro_torch.serving import kvcache

    real = kvcache.dequantize_cache

    def dequantize_cache(q, cfg=kvcache.TensorCodecConfig()):
        cache = real(q, cfg)
        cache.k[0, 0, 0, 0, 0] += 64.0  # one restored value altered
        return cache

    monkeypatch.setattr(kvcache, "dequantize_cache", dequantize_cache)


def _park_unchanged(monkeypatch):
    from repro_torch.serving import kvcache

    real = kvcache.quantize_cache
    first: dict = {}

    def quantize_cache(cache, cfg=kvcache.TensorCodecConfig()):
        key = id(cache.kpos)  # a session's positions travel with it
        if key not in first:
            first[key] = real(cache, cfg)
        return first[key]  # every later park hands back the first parked state

    monkeypatch.setattr(kvcache, "quantize_cache", quantize_cache)


def _restore_stale(monkeypatch):
    from repro_torch.serving import kvcache

    real = kvcache.dequantize_cache
    last: dict = {}

    def dequantize_cache(q, cfg=kvcache.TensorCodecConfig()):
        key = id(q.kpos)
        cache = real(q, cfg)
        return last.setdefault(key, cache)  # every later restore returns the first one

    monkeypatch.setattr(kvcache, "dequantize_cache", dequantize_cache)


@pytest.mark.parametrize("fault", [_restore_altered, _park_unchanged, _restore_stale],
                         ids=["restore_altered", "park_unchanged", "restore_stale"])
def test_broken_kv_park_is_not_correct(make_job, monkeypatch, fault):
    fault(monkeypatch)
    assert not _correct(make_job, KV_CELL, TINY_DENSE, KV_MIX, KV_LIMITS)
