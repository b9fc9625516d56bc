"""The port's RG-LRU and RWKV6 layers and the hybrid (recurrentgemma-9b) and
ssm (rwkv6-1.6b) models against the reference, on the CPU, at
``reduced_config`` sizes with params converted from the reference.

Tolerances and why (measured over seeds 0-2):

* ``_associative_scan`` is ``lax.associative_scan``'s recursion with the
  same combine tree: bit-equal to it run eagerly, at every length tried
  (compiled, XLA fuses ``b1 * a2 + b2`` into an FMA and differs by an ulp).
* ``_rglru_core``: its gates go through float32 ``exp`` and ``sigmoid``,
  whose last bits differ between XLA and torch, so y (bf16) is held within
  one bf16 ulp (rtol 2**-7, measured at most one ulp in 5120) and h
  (float32) within 1e-6 (measured 1.5e-7).  ``rglru_apply`` (train,
  prefill, decode): y within 2**-8 (measured at most 2**-9), the state's h
  within 1e-6 and its conv tail bit-equal.
* ``_wkv_chunked``: y bit-equal in bf16, the float32 state within 1e-5
  (measured 4.3e-6 at |S| ~7).  ``rwkv_apply`` on the chunked and on the
  step path: output and token shifts bit-equal, the WKV state within 4e-6
  (measured 1.4e-6).
* whole models: the bounds of ``tests/test_torch_models.py`` (logits atol
  0.1, rtol 0.05, top-1 off near ties; caches and states atol 0.05, rtol
  0.02; loss 0.01) for the reduced configs, a hybrid of 5 layers (one
  (rec, rec, local) group and a (rec, rec) tail) and an rwkv6 whose
  prefill takes the chunked WKV (chunks of 4 over 16 tokens).  Decoding
  the tokens one by one matches the port's own prefill at the reference
  test's bound (atol 0.35, rtol 0.05, top-1 >= 0.99).
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


def _cfgs(arch, **changes):
    cfg = dataclasses.replace(RC.reduced_config(RC.ARCHS[arch]), **changes)
    return cfg, PC.ModelConfig(**dataclasses.asdict(cfg))


def _pair_arrays(rng, shape, dtype=jnp.bfloat16):
    a = rng.standard_normal(shape).astype(np.float32)
    t = torch.from_numpy(a)
    return jnp.asarray(a, dtype), (t.bfloat16() if dtype == jnp.bfloat16 else t)


# ------------------------------------------------------------------- RG-LRU
@pytest.mark.parametrize("n", [1, 2, 3, 5, 7, 16, 23, 33])  # odd at 1-3 levels of the recursion
def test_associative_scan_bit_equal(n):
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, (2, n, 8)).astype(np.float32)
    b = rng.standard_normal((2, n, 8)).astype(np.float32)

    def combine(lhs, rhs):
        return lhs[0] * rhs[0], lhs[1] * rhs[0] + rhs[1]

    want = jax.lax.associative_scan(combine, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    got = PL._associative_scan(PL._lru_combine, (torch.from_numpy(a), torch.from_numpy(b)), 1)
    for w, g in zip(want, got):
        _bits_equal(w, g)


def _rec_params(seed):
    cfg, pcfg = _cfgs("recurrentgemma-9b")
    p = RL.rglru_init(jax.random.PRNGKey(seed), cfg)
    return cfg, pcfg, p, convert.model_params_from_reference(_np(p), device="cpu")


@pytest.mark.parametrize("seed", [0, 1])
def test_rglru_core_matches_reference(seed):
    _, _, p, pp = _rec_params(seed)
    rng = np.random.default_rng(seed)
    ju, tu = _pair_arrays(rng, (2, 40, 64))
    jh, th = _pair_arrays(rng, (2, 64), jnp.float32)
    wy, wh = RL._rglru_core(ju, p, jh)
    gy, gh = PL._rglru_core(tu, pp, th)
    assert gy.dtype == torch.bfloat16 and gh.dtype == torch.float32
    np.testing.assert_allclose(_f32(gy), _f32(wy), rtol=2**-7, atol=0)
    np.testing.assert_allclose(gh.numpy(), np.asarray(wh), rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_rglru_apply_matches_reference(mode):
    cfg, pcfg, p, pp = _rec_params(3)
    rng = np.random.default_rng(3)
    jx, tx = _pair_arrays(rng, (2, 1 if mode == "decode" else 16, cfg.d_model))
    jst = pst = None
    if mode == "decode":
        h0 = rng.standard_normal((2, 64)).astype(np.float32)
        conv = rng.standard_normal((2, cfg.conv_width - 1, 64)).astype(jnp.bfloat16)
        jst = RL.RecState(h=jnp.asarray(h0), conv=jnp.asarray(conv))
        pst = convert.decode_caches_from_reference({"h": h0, "conv": conv}, device="cpu")
        assert isinstance(pst, PL.RecState)
    wy, ws = RL.rglru_apply(p, jx, cfg, mode=mode, state=jst)
    gy, gs = PL.rglru_apply(pp, tx, pcfg, mode=mode, state=pst)
    np.testing.assert_allclose(_f32(gy), _f32(wy), rtol=0, atol=2**-8)
    assert (ws is None) == (gs is None) == (mode == "train")
    if mode == "decode":
        assert gs is pst  # written in place
    if gs is not None:
        np.testing.assert_allclose(gs.h.numpy(), np.asarray(ws.h), rtol=0, atol=1e-6)
        _bits_equal(ws.conv, gs.conv)


def test_gelu_and_log_sigmoid_follow_the_reference():
    """gelu is the tanh approximation op by op in bf16 (F.gelu rounds once,
    and differs in 2 of 5 values): 4 of 4001 values differ, by at most
    0.0029 where 1 + tanh cancels (the two tanh's last bits differ);
    log sigmoid(lam) follows the reference past softplus' cut at 20."""
    x = np.linspace(-6, 6, 4001).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x, jnp.bfloat16)), np.float32)
    got = _f32(PL._gelu(torch.from_numpy(x).bfloat16()))
    assert (got != want).mean() < 0.01
    np.testing.assert_allclose(got, want, rtol=2**-7, atol=2**-8)
    lam = np.array([-30.0, -21.0, 0.0, 2.0, 21.0, 30.0], np.float32)
    _, _, p, pp = _rec_params(0)
    p = dict(p, lam=jnp.asarray(lam))
    pp = dict(pp, lam=torch.from_numpy(lam))
    u = np.ones((1, 3, 6), np.float32)
    ref_a = RL._rglru_core(jnp.asarray(u), dict(p, wa=jnp.zeros((6, 6)), wx=jnp.zeros((6, 6))),
                           jnp.zeros((1, 6)))[1]
    got_a = PL._rglru_core(torch.from_numpy(u), dict(pp, wa=torch.zeros(6, 6),
                                                     wx=torch.zeros(6, 6)), torch.zeros(1, 6))[1]
    np.testing.assert_allclose(got_a.numpy(), np.asarray(ref_a), rtol=1e-6, atol=1e-7)


# -------------------------------------------------------------------- RWKV6
def _rwkv_params(seed, **changes):
    """rwkv6 layer params with a random decay base and bonus (the init's
    are constant), so every WKV path carries real decay."""
    cfg, pcfg = _cfgs("rwkv6-1.6b", **changes)
    npp = _np(RL.rwkv_init(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    npp["decay_base"] = (rng.standard_normal(npp["decay_base"].shape) * 1.5 - 1).astype(np.float32)
    npp["bonus_u"] = rng.standard_normal(npp["bonus_u"].shape).astype(np.float32)
    return cfg, pcfg, jax.tree.map(jnp.asarray, npp), convert.model_params_from_reference(
        npp, device="cpu")


@pytest.mark.parametrize("seed", [0, 1])
def test_wkv_chunked_matches_reference(seed):
    rng = np.random.default_rng(seed)
    b, s, h, kd = 2, 32, 4, 16
    (jr, tr), (jk, tk), (jv, tv) = (_pair_arrays(rng, (b, s, h, kd)) for _ in range(3))
    w = np.exp(-np.exp(np.clip(rng.standard_normal((b, s, h, kd)) - 1, -20, 2))).astype(np.float32)
    u = rng.standard_normal((h, kd)).astype(np.float32)
    s0 = rng.standard_normal((b, h, kd, kd)).astype(np.float32)
    ws, wy = RL._wkv_chunked(jr, jk, jv, jnp.asarray(w), jnp.asarray(u), jnp.asarray(s0), 8)
    gs, gy = PL._wkv_chunked(tr, tk, tv, torch.from_numpy(w), torch.from_numpy(u),
                             torch.from_numpy(s0), 8)
    _bits_equal(wy, gy)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=0, atol=1e-5)


@pytest.mark.parametrize("path,mode", [("chunked", "train"), ("chunked", "prefill"),
                                       ("step", "train"), ("step", "prefill"),
                                       ("step", "decode")])
def test_rwkv_apply_matches_reference(path, mode):
    cfg, pcfg, p, pp = _rwkv_params(4, rwkv_chunked=4 if path == "chunked" else 0)
    rng = np.random.default_rng(4)
    jx, tx = _pair_arrays(rng, (2, 1 if mode == "decode" else 16, cfg.d_model))
    jst = pst = None
    if mode == "decode":
        nh, hk = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
        st = {"wkv": rng.standard_normal((2, nh, hk, hk)).astype(np.float32),
              "shift_t": rng.standard_normal((2, cfg.d_model)).astype(jnp.bfloat16),
              "shift_c": rng.standard_normal((2, cfg.d_model)).astype(jnp.bfloat16)}
        jst = RL.RwkvState(**{k: jnp.asarray(v) for k, v in st.items()})
        pst = convert.decode_caches_from_reference(st, device="cpu")
        assert isinstance(pst, PL.RwkvState)
    wy, ws = RL.rwkv_apply(p, jx, cfg, mode=mode, state=jst)
    gy, gs = PL.rwkv_apply(pp, tx, pcfg, mode=mode, state=pst)
    _bits_equal(wy, gy)
    assert (ws is None) == (gs is None) == (mode == "train")
    if mode == "decode":
        assert gs is pst  # written in place
    if gs is not None:
        np.testing.assert_allclose(gs.wkv.numpy(), np.asarray(ws.wkv), rtol=0, atol=4e-6)
        _bits_equal(ws.shift_t, gs.shift_t)
        _bits_equal(ws.shift_c, gs.shift_c)


# ------------------------------------------------------------------- models
VARIANTS = [("recurrentgemma-9b", None), ("recurrentgemma-9b", {"n_layers": 5}),
            ("rwkv6-1.6b", None), ("rwkv6-1.6b", {"rwkv_chunked": 4})]


@pytest.fixture(scope="module", params=VARIANTS,
                ids=["recurrentgemma", "recurrentgemma-5L", "rwkv6", "rwkv6-chunked"])
def pair(request):
    return FamilyPair(*request.param)


def test_layouts(pair):
    """recurrentgemma: (rec, rec, local) groups, a (rec, rec) tail past them;
    rwkv6: one rwkv block a group."""
    p, cfg = pair.pp, pair.cfg
    if cfg.family == "hybrid":
        assert set(p["groups"]) == {"pos0", "pos1", "pos2"} and "attn" in p["groups"]["pos2"]
        assert len(p["tail"]) == cfg.n_layers - 3 and all("rec" in t for t in p["tail"])
    else:
        assert set(p["groups"]) == {"pos0"} and "rwkv" in p["groups"]["pos0"]
        assert "mlp" not in p["groups"]["pos0"] and p["tail"] == []


def test_loss_matches_reference(pair):
    check_loss(pair)


def test_prefill_matches_reference(pair, monkeypatch):
    flash = _count_flash(monkeypatch)
    check_prefill(pair)
    assert flash == []  # local attention and RWKV take no flash call


def test_decode_steps_match_reference(pair):
    check_decode_steps(pair, steps=16)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-1.6b"])
def test_incremental_decode_matches_full_forward(arch):
    check_incremental_decode(arch)


def test_local_ring_buffer_wraps():
    """A local layer's decode cache is a ring of min(window, max_seq): past
    the window the reference and the port overwrite the same slots."""
    pair = FamilyPair("recurrentgemma-9b", {"local_window": 4})
    check_decode_steps(pair, steps=10)
