"""The plain references against tiny seeded models on the CPU: the port
agrees with them to bf16 rounding, their MoE capacity rule is the port's,
the codec reference is the port's codec bit for bit, and the controls (one
precision below) read well apart."""
from __future__ import annotations

import torch

from conftest import TINY_DENSE, TINY_MOE
from harness import traffic, weights
from reference import kvcodec, lm

# every expert on every token and no capacity drop: no routing choice that
# bf16 and float32 could make differently
NO_CHOICE_MOE = {**TINY_MOE, "top_k": TINY_MOE["n_experts"], "capacity_factor": 8.0}


def _port_logits(mc: dict, tree: dict, prompts: list) -> list:
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.model import Model

    model = Model(ModelConfig(**mc))
    with torch.no_grad():
        return [model.prefill(tree, {"tokens": t})[0][0, -1].float() for t in prompts]


def _ref(mc: dict, tree: dict, prompts: list, precision: str = "float32") -> list:
    return lm.prefill(mc, tree["embed"], weights.layers(tree), tree["ln_f"], tree["head"],
                      prompts, precision)[0]


def _rel(got, want) -> float:
    return float((got - want).norm() / (want - want.mean()).norm())


def _prompts(mc: dict, seed: int) -> list:
    return [traffic.prompt_tokens(seed, k, n, mc["vocab_size"], "cpu")
            for k, n in enumerate((7, 33, 64))]


def test_port_matches_reference_dense():
    tree = weights.make(TINY_DENSE, 2**31 + 3, "cpu")
    prompts = _prompts(TINY_DENSE, 2**31 + 3)
    for got, want in zip(_port_logits(TINY_DENSE, tree, prompts), _ref(TINY_DENSE, tree, prompts)):
        # bf16 activations against float32 at d_model 64: about 1e-2
        assert _rel(got, want) < 0.03


def test_port_matches_reference_mla_moe():
    tree = weights.make(NO_CHOICE_MOE, 2**31 + 4, "cpu")
    prompts = _prompts(NO_CHOICE_MOE, 2**31 + 4)
    for got, want in zip(_port_logits(NO_CHOICE_MOE, tree, prompts),
                         _ref(NO_CHOICE_MOE, tree, prompts)):
        assert _rel(got, want) < 0.03


def test_moe_capacity_rule_is_the_ports():
    """20 tokens all routed to expert 0 of 2, top 1: the capacity is
    max(8, int(1.25 * 20 / 2)) = 12, so the first 12 rows get the expert's
    output and the rest none, in the reference and in the port."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.layers import moe_apply

    mc = {**TINY_MOE, "n_experts": 2, "top_k": 1, "n_shared_experts": 0}
    d = mc["d_model"]
    g = torch.Generator().manual_seed(5)
    h = torch.randn((20, d), generator=g).abs() + 0.1
    p = {"router": torch.zeros((d, 2)), "wg": torch.randn((2, d, 32), generator=g) * 0.2,
         "wu": torch.randn((2, d, 32), generator=g) * 0.2,
         "wd": torch.randn((2, 32, d), generator=g) * 0.2}
    p["router"][:, 0] = 1.0  # expert 0 wins on every token
    ref = lm.moe(p, h, mc, lm.Arith("float32"))
    port, _ = moe_apply({k: v.to(torch.bfloat16) for k, v in p.items()},
                        h.to(torch.bfloat16)[None], ModelConfig(**mc))
    for y in (ref, port[0].float()):
        assert bool((y[:12].abs().sum(1) > 0).all()) and bool((y[12:] == 0).all())
    assert _rel(port[0, :12].float(), ref[:12]) < 0.02


def test_fp8_control_reads_far_from_the_reference():
    tree = weights.make(TINY_DENSE, 2**31 + 5, "cpu")
    prompts = _prompts(TINY_DENSE, 2**31 + 5)
    ref = _ref(TINY_DENSE, tree, prompts)
    sound = max(_rel(a, b) for a, b in zip(_port_logits(TINY_DENSE, tree, prompts), ref))
    control = max(_rel(a, b) for a, b in zip(_ref(TINY_DENSE, tree, prompts, "fp8"), ref))
    assert control > 3 * sound


def test_codec_reference_is_the_ports_codec_bit_for_bit():
    from repro_torch.core.tensorshrink import TensorCodecConfig
    from repro_torch.models.layers import AttnCache
    from repro_torch.serving.kvcache import dequantize_cache, quantize_cache

    k, v = traffic.kv_cache(2**31 + 6, 0, 48, 2, 2, 128, {"k_spread": 1.0, "v_spread": 0.5},
                            "cpu")
    kpos = torch.arange(48, dtype=torch.int32).expand(2, 1, 48).contiguous()
    codec = TensorCodecConfig()
    cache = AttnCache(k, v, kpos)
    for _ in range(3):
        cache = dequantize_cache(quantize_cache(cache, codec), codec)
    for got, orig in ((cache.k, k), (cache.v, v)):
        want, steps = kvcodec.chain(orig, 3)
        assert torch.equal(got, want)
        assert kvcodec.deviation(got, want, steps) == (0.0, 0.0)
        four, _ = kvcodec.chain(orig, 3, bits=4)
        worst, rms = kvcodec.deviation(four, want, steps)
        assert worst > 5 and rms > 1  # 4-bit steps are about 18 of the 8-bit ones


def test_port_cache_matches_reference_cache():
    """The last layer's cache rows (MLA's latent and rope key, or K and V)
    of the port's prefill against the reference's, at every position."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.model import Model

    from harness import common

    runner = common.load_module("runners", "prefill")
    for mc in (TINY_DENSE, NO_CHOICE_MOE):
        tree = weights.make(mc, 2**31 + 8, "cpu")
        prompts = _prompts(mc, 2**31 + 8)
        model = Model(ModelConfig(**mc))
        with torch.no_grad():
            got = [runner.last_cache_rows(model.prefill(tree, {"tokens": t})[1]) for t in prompts]
        _, want = lm.prefill(mc, tree["embed"], weights.layers(tree), tree["ln_f"], tree["head"],
                             prompts)
        for g, w, t in zip(got, want, prompts):
            assert g.shape == w.shape and g.shape[0] == t.shape[1]
            assert runner.cache_err(g, w) < 0.03  # bf16 rows against float32: about 1e-2


def test_cache_err_sees_a_run_of_positions_and_not_one_position():
    from harness import common

    runner = common.load_module("runners", "prefill")
    g = torch.Generator().manual_seed(11)
    ref = torch.randn((64, 16), generator=g)
    near = ref * (1 + 0.01 * torch.randn((64, 16), generator=g))
    assert runner.cache_err(near, ref) < 0.02
    flipped = near.clone()
    flipped[5] = -flipped[5]  # one position far off, as a routing flip leaves it
    assert runner.cache_err(flipped, ref) < 0.02
    late = near.clone()
    late[56:] = -late[56:]  # the last eighth of the positions wrong
    assert runner.cache_err(late, ref) > 1.0
    assert runner.cache_err(near[:32], ref) == float("inf")
