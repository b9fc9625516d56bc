"""The port's cross-attention, encoder and the two models that use them
(llama-3.2-vision-11b, seamless-m4t-medium) against the reference, on the
CPU, at ``reduced_config`` sizes with params converted from the reference;
and the cache carry-over of every family.

Tolerances and why:

* a cross block (self-attention on the ``_sdpa`` route, then cross
  attention over the context) in train, prefill and decode
  (``"decode_cross"`` against a prefill-built cross cache), run eagerly on
  both sides.  Its pieces (norms, the two attentions, the MLP) are
  bit-equal on the dense test's shapes, but a bf16 product over 16 context
  tokens rounds one element in 1024 an ulp apart from XLA's (the cross V
  of ``cross_prefill_cache``), and the block carries that on: caches
  within one bf16 ulp (rtol 2**-7), the output within rtol 2**-7 and atol
  2**-5 (measured: 1.4% of the values differ, by at most 2**-6).
* ``encode``: the reference runs its encoder stack as a ``lax.scan``,
  compiled, and XLA keeps bf16 intermediates in float32 there: within
  rtol 2**-6 and atol 2**-5 (measured at most 2**-5 at |x| <= 3).
* whole models: the bounds of ``tests/test_torch_models.py`` (logits atol
  0.1, rtol 0.05, top-1 off near ties; caches atol 0.05, rtol 0.02; loss
  0.01).  Decoding the tokens one by one (cross caches grafted from a
  prefill of the first token, as the reference test does) matches the
  port's own prefill at the reference test's bound (atol 0.35, rtol
  0.05, top-1 >= 0.99).
* The reference's encoder-decoder never reads its encoder (its block group
  is ``("attn",)``, so no decoder layer cross-attends): its logits do not
  depend on the frames, and the port holds to that.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models import build_model as ref_build
from repro.models import transformer as RT
from test_torch_models import _bits_equal, _count_flash, _f32, _np

import repro_torch.configs as PC
from repro_torch import convert
from repro_torch.models import build_model
from repro_torch.models import transformer as PT
from torch_family_pairs import (FamilyPair, check_decode_steps, check_incremental_decode,
                                check_loss, check_prefill, to_jax, to_torch)

CROSS_ARCHS = ["llama-3.2-vision-11b", "seamless-m4t-medium"]


def _cfgs(arch, **changes):
    cfg = dataclasses.replace(RC.reduced_config(RC.ARCHS[arch]), **changes)
    return cfg, PC.ModelConfig(**dataclasses.asdict(cfg))


def _arrays(seed, shape):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).bfloat16()


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_cross_block_matches_reference(mode):
    """The VLM's cross block (kind ``"cross"``), eagerly, on the ``_sdpa``
    route for its self-attention (``attn_softmax_bf16``)."""
    cfg, pcfg = _cfgs("llama-3.2-vision-11b", attn_softmax_bf16=True)
    p = RT.block_init(jax.random.PRNGKey(7), cfg, cfg.n_layers - 1, "cross")
    pp = convert.model_params_from_reference(_np(p), device="cpu")
    assert set(pp) == {"ln1", "ln2", "attn", "ln_cross", "cross_attn", "mlp"}
    b, s = 2, 1 if mode == "decode" else 12
    jx, tx = _arrays(7, (b, s, cfg.d_model))
    jsrc, tsrc = _arrays(8, (b, cfg.vision_tokens, cfg.d_model))
    if mode == "decode":
        idx = 5
        pos = np.full((b, 1), idx, np.int32)
        caches = RT.init_cache_for_kind(cfg, "cross", b, 8, cfg.vision_tokens)
        caches["cross"] = RT.cross_prefill_cache(p, jsrc, cfg)
        pc = PT.init_cache_for_kind(pcfg, "cross", b, 8, pcfg.vision_tokens, device="cpu")
        pc["cross"] = PT.cross_prefill_cache(pp, tsrc, pcfg)
        for f in ("k", "v"):
            np.testing.assert_allclose(_f32(getattr(pc["cross"], f)),
                                       _f32(getattr(caches["cross"], f)), rtol=2**-7, atol=0)
        np.testing.assert_array_equal(pc["cross"].kpos.numpy(), np.asarray(caches["cross"].kpos))
        jkw, tkw = dict(cache=caches, cache_index=jnp.asarray(idx, jnp.int32)), dict(
            cache=pc, cache_index=idx)
    else:
        pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s))
        jkw, tkw = dict(cross_source=jsrc), dict(cross_source=tsrc)
    want, wc, waux = RT.block_apply(p, jx, cfg, "cross", mode=mode, positions=jnp.asarray(pos),
                                    **jkw)
    got, gc, gaux = PT.block_apply(pp, tx, pcfg, "cross", mode=mode,
                                   positions=torch.from_numpy(pos), **tkw)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2**-7, atol=2**-5)
    assert float(gaux) == float(waux) == 0.0
    assert (wc is None) == (gc is None)
    if wc is not None:
        assert set(gc) == set(wc)
        for name in wc:
            for f in ("k", "v", "kpos"):
                np.testing.assert_allclose(_f32(getattr(gc[name], f)),
                                           _f32(getattr(wc[name], f)), rtol=2**-7, atol=0)


def test_encode_matches_reference():
    cfg, pcfg = _cfgs("seamless-m4t-medium")
    params = ref_build(cfg).init(jax.random.PRNGKey(9))
    pp = convert.model_params_from_reference(_np(params), device="cpu")
    assert pp["encoder"]["ln1"].shape[0] == cfg.n_enc_layers and "enc_ln_f" in pp
    jf, tf = _arrays(9, (2, 8, cfg.d_model))
    np.testing.assert_allclose(_f32(PT.encode(pp, tf, pcfg)), _f32(RT.encode(params, jf, cfg)),
                               rtol=2**-6, atol=2**-5)


# ------------------------------------------------------------------- models
@pytest.fixture(scope="module", params=CROSS_ARCHS)
def pair(request):
    return FamilyPair(request.param)


def test_loss_matches_reference(pair):
    check_loss(pair)


def test_prefill_matches_reference(pair, monkeypatch):
    flash = _count_flash(monkeypatch)
    check_prefill(pair)
    # every decoder layer's causal self-attention (the VLM's cross layers
    # too); the cross attention and the encoder take _sdpa
    assert len(flash) == pair.cfg.n_layers


def test_decode_steps_match_reference(pair, monkeypatch):
    flash = _count_flash(monkeypatch)
    check_decode_steps(pair)
    assert flash == []


@pytest.mark.parametrize("arch", CROSS_ARCHS)
def test_incremental_decode_matches_full_forward(arch):
    check_incremental_decode(arch)


def test_encdec_logits_do_not_read_the_frames():
    """The reference's defect, mirrored: seamless runs its encoder, but no
    decoder layer reads it, so other frames give the same logits."""
    pair = FamilyPair("seamless-m4t-medium")
    other = dict(pair.batch, frames=pair.batch["frames"] * -3.0)
    w1, _ = jax.jit(pair.ref.prefill)(pair.params, to_jax(pair.batch))
    w2, _ = jax.jit(pair.ref.prefill)(pair.params, to_jax(other))
    g1, _ = pair.port.prefill(pair.pp, to_torch(pair.batch))
    g2, _ = pair.port.prefill(pair.pp, to_torch(other))
    _bits_equal(w1, w2)
    _bits_equal(g1, g2)


def test_vlm_logits_read_the_vision_tokens():
    pair = FamilyPair("llama-3.2-vision-11b")
    other = dict(pair.batch, vision=pair.batch["vision"] * -3.0)
    g1, _ = pair.port.prefill(pair.pp, to_torch(pair.batch))
    g2, _ = pair.port.prefill(pair.pp, to_torch(other))
    assert not torch.equal(g1, g2)


# ------------------------------------------------------- cache carry-over
@pytest.mark.parametrize("arch", sorted(RC.ARCHS))
def test_decode_caches_convert_key_for_key(arch):
    """A reference decode-cache tree of every family converts to the port's
    layout: the same keys, classes, shapes and dtypes as the port's own
    ``make_decode_caches``, with the reference's values."""
    cfg = RC.reduced_config(RC.ARCHS[arch])
    want = ref_build(cfg).make_decode_caches(2, 24)
    got = convert.decode_caches_from_reference(_np(want), device="cpu")
    own = build_model(PC.reduced_config(PC.ARCHS[arch])).make_decode_caches(2, 24, device="cpu")

    def walk(w, g, o):
        if isinstance(w, dict):
            assert set(g) == set(w) == set(o)
            for k in w:
                walk(w[k], g[k], o[k])
        elif isinstance(w, list):
            assert len(g) == len(w) == len(o)
            for x in zip(w, g, o):
                walk(*x)
        else:
            assert type(g) is type(o) and type(g).__name__ == type(w).__name__
            for f in dataclasses.fields(w):
                a, t, t_own = np.asarray(getattr(w, f.name)), getattr(g, f.name), getattr(o, f.name)
                assert tuple(t.shape) == a.shape == tuple(t_own.shape)
                assert t.dtype == t_own.dtype
                np.testing.assert_array_equal(_f32(t), a.astype(np.float32))
    walk(want, got, own)
    if cfg.family in ("moe", "hybrid", "ssm"):
        kinds = {type(c).__name__ for c in _leaves(got)}
        assert kinds == {"moe": {"MLACache"} if cfg.mla else {"AttnCache"},
                         "hybrid": {"AttnCache", "RecState"}, "ssm": {"RwkvState"}}[cfg.family]


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("arch", CROSS_ARCHS)
def test_cross_len_equals_reference(arch):
    """The decode caches' cross length: the VLM's vision tokens, the
    encoder-decoder's ``seq * audio_frames_ratio`` (the reference's
    ``_cross_len``)."""
    for seq in (24, 2064, 32768):
        assert build_model(PC.get_config(arch))._cross_len(seq) == ref_build(
            RC.get_config(arch))._cross_len(seq)
