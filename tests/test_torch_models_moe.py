"""The port's MLA and MoE layers and the two MoE models (deepseek-v2-lite-16b,
llama4-maverick-400b-a17b) against the reference, on the CPU, at
``reduced_config`` sizes with params converted from the reference.

Tolerances and why:

* MLA run eagerly on both sides: the expanded prefill on the ``_sdpa``
  route (``attn_softmax_bf16``, the reference's call) and the absorbed
  decode (one-hot masked and slice writes) are bit-equal in bf16, and so
  are the caches.  The prefill's flash route (one call at head dim
  nope + rope, V padded) multiplies float32 probabilities where the
  reference rounds them to bf16: within one bf16 ulp of |out| <= 2
  (2**-6) of the reference's output.
* ``moe_apply`` run eagerly: the router product is float32 on both sides
  but summed in other orders, so the aux loss is held at rtol 2e-5
  (measured at most 8.8e-6, where one expert's logits are ~40); the output
  is bit-equal wherever the routing is the same (every case here: plain,
  capacity drops, a tie in the router, every token on one expert).  Ties
  take the lower expert as ``lax.top_k`` does.
* whole models: the bounds of ``tests/test_torch_models.py`` (logits atol
  0.1, rtol 0.05 and top-1 off near ties; caches atol 0.05, rtol 0.02;
  loss and each loss part 0.01), for the reduced configs (deepseek: the
  dense prefix layer and one MoE layer; llama4: one group, a dense pos0
  and an MoE pos1) and for a deepseek of 3 layers (the prefix and two
  stacked MoE groups).  The bound holds the caches of the first two layers
  as it does for the dense models, which have two; the rounding drifts
  further with depth, and the third layer's latent cache differs by up
  to 0.0547 at |x| ~0.18 (measured over seeds 0-2), so the 3-layer
  variant's third-layer caches are not held to it, its logits are.
  Decoding the tokens one by one matches the port's own prefill at the
  reference test's bound (atol 0.35, rtol 0.05, top-1 >= 0.99).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models import layers as RL
from test_torch_models import _bits_equal, _count_flash, _f32, _np

import repro_torch.configs as PC
from repro_torch import convert
from repro_torch.models import layers as PL
from torch_family_pairs import (FamilyPair, check_decode_steps, check_incremental_decode,
                                check_loss, check_prefill)

MOE_ARCHS = ["deepseek-v2-lite-16b", "llama4-maverick-400b-a17b"]


def _cfgs(arch="deepseek-v2-lite-16b", **changes):
    cfg = dataclasses.replace(RC.reduced_config(RC.ARCHS[arch]), **changes)
    return cfg, PC.ModelConfig(**dataclasses.asdict(cfg))


def _x(seed, b, s, d):
    x = np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()


# ---------------------------------------------------------------------- MLA
@pytest.mark.parametrize("route", ["sdpa", "flash"])
@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_mla_expanded_matches_reference(route, mode, monkeypatch):
    cfg, pcfg = _cfgs(attn_softmax_bf16=route == "sdpa")
    p = RL.mla_init(jax.random.PRNGKey(1), cfg)
    pp = convert.model_params_from_reference(_np(p), device="cpu")
    b, s = 2, 12
    jx, tx = _x(1, b, s, cfg.d_model)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s))
    want, wc = RL.mla_apply(p, jx, cfg, positions=jnp.asarray(pos), mode=mode)
    flash = _count_flash(monkeypatch)
    got, gc = PL.mla_apply(pp, tx, pcfg, positions=torch.from_numpy(pos), mode=mode)
    qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    if route == "sdpa":
        assert flash == []
        _bits_equal(want, got)
    else:
        assert flash == [((b, s, cfg.n_heads, qk), (b, s, cfg.n_heads, qk), True)]
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=0, atol=2**-6)
    assert (wc is None) == (gc is None) == (mode == "train")
    if gc is not None:
        for f in ("c_kv", "k_rope", "kpos"):
            _bits_equal(getattr(wc, f), getattr(gc, f))


@pytest.mark.parametrize("masked", [False, True])
def test_mla_absorbed_decode_bit_equal(masked):
    cfg, pcfg = _cfgs(masked_cache_update=masked)
    p = RL.mla_init(jax.random.PRNGKey(2), cfg)
    pp = convert.model_params_from_reference(_np(p), device="cpu")
    rng = np.random.default_rng(2)
    b, buf, idx = 2, 16, 9
    c_kv = rng.standard_normal((b, buf, cfg.kv_lora_rank)).astype(jnp.bfloat16)
    k_rope = rng.standard_normal((b, buf, cfg.qk_rope_head_dim)).astype(jnp.bfloat16)
    kpos = np.repeat(np.where(np.arange(buf) < idx, np.arange(buf), -1)[None], b, 0)
    kpos = kpos.astype(np.int32)
    jc = RL.MLACache(jnp.asarray(c_kv), jnp.asarray(k_rope), jnp.asarray(kpos))
    tc = convert.decode_caches_from_reference(
        {"c_kv": c_kv, "k_rope": k_rope, "kpos": kpos}, device="cpu")
    assert isinstance(tc, PL.MLACache)
    jx, tx = _x(3, b, 1, cfg.d_model)
    pos = np.full((b, 1), idx, np.int32)
    want, wc = RL.mla_apply(p, jx, cfg, positions=jnp.asarray(pos), mode="decode", cache=jc,
                            cache_index=jnp.asarray(idx, jnp.int32))
    got, gc = PL.mla_apply(pp, tx, pcfg, positions=torch.from_numpy(pos), mode="decode",
                           cache=tc, cache_index=idx)
    assert gc is tc  # written in place
    _bits_equal(want, got)
    for f in ("c_kv", "k_rope", "kpos"):
        _bits_equal(getattr(wc, f), getattr(gc, f))


# ---------------------------------------------------------------------- MoE
def _moe_case(case):
    """(cfg, pcfg, reference params, the port's, x as jax and torch) for
    one routing case."""
    changes = {"plain": {}, "drops": {"capacity_factor": 0.5},
               "tie": {}, "full_expert": {"capacity_factor": 1.0}}[case]
    cfg, pcfg = _cfgs(**changes)
    p = RL.moe_init(jax.random.PRNGKey(5), cfg)
    npp = _np(p)
    npp["router"] = npp["router"].copy()
    if case == "tie":
        # experts 1 and 2 route alike: equal probabilities on every token
        npp["router"][:, 2] = npp["router"][:, 1]
    elif case == "full_expert":
        # every token prefers expert 3: it overflows its capacity
        npp["router"][:, 3] = 0.0
        npp["router"][0, 3] = 40.0
    p = jax.tree.map(jnp.asarray, npp)
    pp = convert.model_params_from_reference(npp, device="cpu")
    jx, tx = _x(6, 4, 24, cfg.d_model)
    if case == "full_expert":
        jx, tx = jnp.abs(jx), tx.abs()
    return cfg, pcfg, p, pp, jx, tx


@pytest.mark.parametrize("case", ["plain", "drops", "tie", "full_expert"])
def test_moe_apply_matches_reference(case):
    cfg, pcfg, p, pp, jx, tx = _moe_case(case)
    if case == "full_expert":  # every token's first choice is expert 3, past its capacity
        n_tok = tx.shape[0] * tx.shape[1]
        assert max(8, int(cfg.capacity_factor * n_tok * cfg.top_k / cfg.n_experts)) < n_tok
        probs = torch.softmax(tx.reshape(n_tok, -1).float() @ pp["router"].float(), -1)
        assert bool((probs.argmax(-1) == 3).all())
    want, waux = RL.moe_apply(p, jx, cfg)
    got, gaux = PL.moe_apply(pp, tx, pcfg)
    assert got.dtype == torch.bfloat16 and gaux.dtype == torch.float32
    _bits_equal(want, got)
    np.testing.assert_allclose(float(gaux), float(waux), rtol=2e-5)


def test_moe_routing_takes_the_lower_expert_on_ties():
    probs = np.array([[0.2, 0.3, 0.3, 0.2], [0.25] * 4, [0.1, 0.4, 0.1, 0.4]], np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs), 2)
    got_v, got_i = (t[:, :2] for t in torch.sort(torch.from_numpy(probs), dim=-1,
                                                  descending=True, stable=True))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


# ------------------------------------------------------------------- models
VARIANTS = [(arch, None) for arch in MOE_ARCHS] + [("deepseek-v2-lite-16b", {"n_layers": 3})]


@pytest.fixture(scope="module", params=VARIANTS, ids=lambda v: v[0] + ("-3L" if v[1] else ""))
def pair(request):
    arch, changes = request.param
    return FamilyPair(arch, changes)


def test_layouts(pair):
    """deepseek: the dense first layer in the prefix, MoE in the groups;
    llama4: a dense pos0 and an MoE pos1."""
    p = pair.pp
    if pair.cfg.mla:
        assert len(p["prefix"]) == 1 and "mlp" in p["prefix"][0] and "moe" in p["groups"]["pos0"]
        assert set(p["groups"]) == {"pos0"}
        assert p["groups"]["pos0"]["ln1"].shape[0] == pair.cfg.n_layers - 1
    else:
        assert p["prefix"] == [] and "mlp" in p["groups"]["pos0"] and "moe" in p["groups"]["pos1"]


def test_loss_matches_reference(pair):
    check_loss(pair)


def test_prefill_matches_reference(pair, monkeypatch):
    flash = _count_flash(monkeypatch)
    check_prefill(pair, cache_groups=2 - len(pair.pp["prefix"]))
    assert len(flash) == pair.cfg.n_layers  # one causal self-attention call a layer


def test_decode_steps_match_reference(pair, monkeypatch):
    flash = _count_flash(monkeypatch)
    check_decode_steps(pair)
    assert flash == []


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_incremental_decode_matches_full_forward(arch):
    check_incremental_decode(arch)
