"""The port's tracing (``repro_torch.core.trace``) on the CPU: under a
recording profiler a prefill and the KV codec emit every span, nested as
the layers nest, the MoE counters agree with a recount of the router's
choices, and nothing the program computes changes; with no profiler a span
is the shared no-op and no counter moves."""
from __future__ import annotations

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.base import ModelConfig
from repro_torch.core import trace
from repro_torch.core.tensorshrink import TensorCodecConfig
from repro_torch.models import layers
from repro_torch.models.layers import AttnCache
from repro_torch.models.model import Model
from repro_torch.serving.kvcache import dequantize_cache, quantize_cache
from repro_torch.training._tree import leaves
from repro_torch.training.train_step import _value_and_grad

DENSE = dict(name="tiny-dense", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
             head_dim=16, d_ff=128, vocab_size=512, rope_theta=10000.0, norm_eps=1e-5,
             tie_embeddings=False, param_dtype="bfloat16")
MOE = dict(name="tiny-moe", family="moe", n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
           d_ff=96, vocab_size=512, rope_theta=10000.0, norm_eps=1e-6, tie_embeddings=False,
           mla=True, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
           v_head_dim=16, n_experts=8, n_shared_experts=2, top_k=2, moe_d_ff=32,
           first_dense_layers=1, capacity_factor=1.25, param_dtype="bfloat16")
PROGRAM = ("model.", "block.", "attn.", "moe.", "kv.", "codec.")
# each span name and the span it sits directly in
PARENT = {"model.embed": None, "model.stack": None, "model.head": None,
          "model.caches": "model.stack", "block.mixer": "model.stack",
          "block.ffn": "model.stack", "attn.flash": "block.mixer", "moe.route": "block.ffn",
          "moe.aux": "block.ffn", "moe.dispatch": "block.ffn", "moe.count": "moe.dispatch",
          "moe.experts": "block.ffn", "moe.combine": "block.ffn", "moe.shared": "block.ffn",
          "kv.park": None, "kv.restore": None, "codec.blockify": "kv.park",
          "codec.fit": "kv.park", "codec.step": "kv.park", "codec.quant": "kv.park",
          "codec.dequant": "kv.restore"}


@pytest.fixture(autouse=True)
def _zeroed_counters():
    trace.reset_counts()
    yield
    trace.reset_counts()


def _spans(prof) -> list[tuple[str, int, int]]:
    """(name, start, end) of the program's ranges in a CPU trace."""
    return sorted(((e.name(), e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith(PROGRAM)), key=lambda s: (s[1], -s[2]))


def _parents(spans) -> dict:
    """Each span's name -> the set of names of the spans directly around it."""
    out: dict = {}
    for i, (name, a, b) in enumerate(spans):
        around = [s for s in spans[:i] if s[1] <= a and b <= s[2]]
        out.setdefault(name, set()).add(around[-1][0] if around else None)
    return out


def _prefill(mc: dict, profiled: bool):
    model = Model(ModelConfig(**mc))
    params = model.init(0, device="cpu")
    tokens = torch.randint(0, mc["vocab_size"], (1, 40), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        if not profiled:
            return model.prefill(params, {"tokens": tokens}), None
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = model.prefill(params, {"tokens": tokens})
    return out, prof


@pytest.mark.parametrize("mc", [DENSE, MOE], ids=["dense", "mla_moe"])
def test_prefill_emits_every_span_nested(mc):
    _, prof = _prefill(mc, True)
    spans = _spans(prof)
    names = [s[0] for s in spans]
    n = mc["n_layers"]
    moe_layers = n - mc.get("first_dense_layers", 0) if mc.get("n_experts") else 0
    want = {"model.embed": 1, "model.stack": 1, "model.caches": 1, "model.head": 1,
            "block.mixer": n, "block.ffn": n, "attn.flash": n}
    if moe_layers:
        want.update({k: moe_layers for k in ("moe.route", "moe.aux", "moe.dispatch",
                                             "moe.count", "moe.experts", "moe.combine",
                                             "moe.shared")})
    assert {k: names.count(k) for k in set(names)} == want
    assert _parents(spans) == {k: {PARENT[k]} for k in want}


def test_kv_park_and_restore_emit_codec_spans():
    cache = _cache()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        parked = quantize_cache(cache, TensorCodecConfig())
        dequantize_cache(parked)
    spans = _spans(prof)
    names = [s[0] for s in spans]
    want = {"kv.park": 1, "kv.restore": 1, "codec.blockify": 2, "codec.fit": 2,
            "codec.step": 2, "codec.quant": 2, "codec.dequant": 2}  # K and V each
    assert {k: names.count(k) for k in set(names)} == want
    assert _parents(spans) == {k: {PARENT[k]} for k in want}


def _cache() -> AttnCache:
    g = torch.Generator().manual_seed(3)
    k, v = (torch.randn(2, 1, 300, 2, 16, generator=g).to(torch.bfloat16) for _ in range(2))
    return AttnCache(k, v, torch.arange(300, dtype=torch.int32).expand(2, 1, 300).contiguous())


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    if dataclasses.is_dataclass(tree):
        return [t for f in dataclasses.fields(tree) for t in _tensors(getattr(tree, f.name))]
    return []


@pytest.mark.parametrize("mc", [DENSE, MOE], ids=["dense", "mla_moe"])
def test_prefill_bits_equal_with_the_profiler_on_and_off(mc):
    (off_logits, off_caches), _ = _prefill(mc, False)
    (on_logits, on_caches), _ = _prefill(mc, True)
    assert torch.equal(off_logits, on_logits)
    off, on = _tensors(off_caches), _tensors(on_caches)
    assert len(off) == len(on) > 0 and all(torch.equal(a, b) for a, b in zip(off, on))


def test_parked_and_restored_bits_equal_with_the_profiler_on_and_off():
    off = quantize_cache(_cache())
    with profile(activities=[ProfilerActivity.CPU]):
        on = quantize_cache(_cache())
        on_back = dequantize_cache(on)
    off_back = dequantize_cache(off)
    for a, b in zip(_tensors([off.k, off.v, off_back]), _tensors([on.k, on.v, on_back])):
        assert torch.equal(a, b)


def test_training_with_remat_under_the_profiler_gives_equal_gradients():
    """The counters run inside checkpointed regions (``remat_policy="dots"``
    is a selective checkpoint, which refuses in-place updates of state
    outside the region on its recompute)."""
    cfg = dataclasses.replace(ModelConfig(**MOE), remat=True, remat_policy="dots")
    model = Model(cfg)
    params = model.init(0, device="cpu")
    tokens = torch.randint(0, 512, (2, 32), generator=torch.Generator().manual_seed(2))
    batch = {"tokens": tokens, "labels": tokens}
    l1, _, g1 = _value_and_grad(model, params, batch)
    with profile(activities=[ProfilerActivity.CPU]):
        l2, _, g2 = _value_and_grad(model, params, batch)
    assert torch.equal(l1, l2) and all(torch.equal(a, b) for a, b in zip(leaves(g1), leaves(g2)))
    assert trace.counts()["moe.kept"] > 0


def test_off_a_span_is_the_shared_no_op_and_no_counter_moves():
    assert not trace.recording()
    assert trace.span("model.stack") is trace.span("moe.route")
    trace.count("moe.kept", torch.tensor(5))
    trace.count("moe.slots", 7)
    _prefill(MOE, False)
    quantize_cache(_cache())
    assert trace.counts() == {}


def test_counters_sum_host_and_device_values_and_reset():
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.recording()
        trace.count("a", 2)
        trace.count("a", torch.tensor(3))
        trace.count("b", torch.tensor(4))
        trace.count("c", torch.empty((), dtype=torch.int64, device="meta"))  # no value
    assert trace.counts() == {"a": 5, "b": 4}
    trace.reset_counts()
    assert trace.counts() == {}


def test_moe_counters_match_a_recount_of_the_router(monkeypatch):
    chosen = []
    route = layers._route

    def recorded(p, xt, cfg):
        out = route(p, xt, cfg)
        chosen.append(out[2].clone())  # the experts [T, k]
        return out

    monkeypatch.setattr(layers, "_route", recorded)
    _prefill(MOE, True)
    c = trace.counts()
    e, k, cf = MOE["n_experts"], MOE["top_k"], MOE["capacity_factor"]
    routed = kept = dropped = slots = 0
    for idx in chosen:
        n_tok = idx.shape[0]
        cap = max(8, int(cf * n_tok * k / e))
        per_expert = torch.bincount(idx.reshape(-1), minlength=e)
        routed += n_tok * k
        kept += int(per_expert.clamp(max=cap).sum())
        dropped += int((per_expert - cap).clamp(min=0).sum())
        slots += e * cap
    assert len(chosen) == MOE["n_layers"] - MOE["first_dense_layers"]
    assert c == {"moe.routed": routed, "moe.kept": kept, "moe.slots": slots}
    assert c["moe.kept"] + dropped == c["moe.routed"]
    assert c["moe.kept"] <= c["moe.slots"]
    assert dropped > 0  # 40 tokens top-2 over 8 experts at capacity 12: some are dropped
