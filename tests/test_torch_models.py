"""The port's dense models (``repro_torch.configs`` and ``repro_torch.models``)
against the reference, on the CPU, at ``reduced_config`` sizes with params
converted from the reference (``convert.model_params_from_reference``).

Tolerances and why:

* configs: equal field for field (``dataclasses.asdict``), all ten archs.
* ``rmsnorm``, ``rope``, ``_sdpa`` (decode and one-chunk forms) and one
  attention layer run eagerly (the reference's ops one by one): bit-equal
  in bf16.  ``_sdpa`` chunked over Sq = 2048: within one bf16 ulp of the
  output (the two frameworks sum the long softmax rows in other orders).
* whole models: the reference compiles its layer stack (``lax.scan``), and
  XLA then keeps some bf16 intermediates in float32 (the residual sum that
  feeds the next RMSNorm, for one), while the port rounds every op to its
  dtype; the port's prefill and forward also take the flash-attention
  route (float32 probabilities) where the reference rounds them to bf16.
  So logits are held at atol 0.1, rtol 0.05 (measured at most 0.0625 over
  three seeds of the four archs), inside the reference's own
  prefill-vs-decode bound (atol 0.35, rtol 0.05;
  ``tests/test_models_smoke.py``); the top-1 token must agree on every
  prefill and decode row whose reference margin exceeds twice the row's
  largest difference (qwen3's tied-embedding logits are at most ~0.5, and
  one of its 32 decode rows is a near tie that flips); the loss at 0.01 (measured
  at most 0.0037), and caches at atol 0.05, rtol 0.02 (at most 0.039: one
  bf16 ulp at |x| in [4, 8)).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models import build_model as ref_build
from repro.models import layers as RL
from repro.models import transformer as RT

import repro_torch.configs as PC
from repro_torch import convert
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.models import layers as PL
from repro_torch.models import transformer as PT
from repro_torch.models.model import _positions

DENSE = sorted(n for n, c in RC.ARCHS.items() if c.family == "dense")
LOGIT_TOL = dict(atol=0.1, rtol=0.05)
CACHE_TOL = dict(atol=0.05, rtol=0.02)
LOSS_TOL = 0.01


def _np(tree):
    """A reference pytree as nested dicts and lists of numpy arrays."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    if dataclasses.is_dataclass(tree):
        return {f.name: np.asarray(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    return np.asarray(tree)


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close_logits(want, got):
    """Within LOGIT_TOL, and the same top-1 token on every row whose
    reference margin (top two logits) exceeds twice the largest difference
    of that row: a closer tie may flip either way."""
    want, got = _f32(want), _f32(got)
    np.testing.assert_allclose(got, want, **LOGIT_TOL)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2 * np.abs(got - want).max(axis=-1)
    assert np.array_equal(want.argmax(-1)[clear], got.argmax(-1)[clear])


def _close_caches(want, got):
    w, g = want["groups"]["pos0"]["self"], got["groups"]["pos0"]["self"]
    for f in ("k", "v"):
        np.testing.assert_allclose(_f32(getattr(g, f)), _f32(getattr(w, f)), **CACHE_TOL)
    np.testing.assert_array_equal(g.kpos.numpy(), np.asarray(w.kpos))


class Pair:
    """One dense arch at its reduced config: the reference model and params,
    the port's model and the converted params, and seeded tokens."""

    def __init__(self, arch: str, seed: int = 0, b: int = 2, s: int = 16):
        self.cfg = RC.reduced_config(RC.ARCHS[arch])
        self.pcfg = PC.reduced_config(PC.ARCHS[arch])
        self.ref, self.port = ref_build(self.cfg), build_model(self.pcfg)
        self.params = self.ref.init(jax.random.PRNGKey(seed))
        self.pp = convert.model_params_from_reference(_np(self.params), device="cpu")
        rng = np.random.default_rng(seed)
        self.toks = rng.integers(0, self.cfg.vocab_size, (b, s)).astype(np.int32)
        self.b, self.s = b, s

    def tokens(self, sl=slice(None)):
        return jnp.asarray(self.toks[:, sl]), torch.from_numpy(self.toks[:, sl]).long()


@pytest.fixture(scope="module", params=DENSE)
def pair(request):
    return Pair(request.param)


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", sorted(RC.ARCHS))
def test_configs_equal_reference(arch):
    ref, port = RC.get_config(arch), PC.get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(PC.reduced_config(port)) == dataclasses.asdict(RC.reduced_config(ref))
    assert PC.cells_for(port) == RC.cells_for(ref)
    assert port.param_count() == ref.param_count()
    assert {k: dataclasses.asdict(v) for k, v in PC.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in RC.SHAPES.items()}


@pytest.mark.parametrize("arch", sorted(PC.ARCHS))
def test_build_model_takes_every_family(arch):
    """Every config builds; at its reduced size it inits on the CPU, and its
    prefill and a decode step from empty caches give logits of the padded
    vocabulary, finite."""
    cfg = PC.reduced_config(PC.ARCHS[arch])
    m = build_model(cfg)
    assert m.cfg is cfg and build_model(PC.ARCHS[arch]).cfg is PC.ARCHS[arch]
    params = m.init(2, device="cpu")
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)))
    batch = {"tokens": toks}
    if cfg.family == "encdec":
        batch = {"tokens": toks[:, :8],
                 "frames": torch.from_numpy(rng.standard_normal((2, 8, cfg.d_model))).float()}
    elif cfg.family == "vlm":
        batch["vision"] = torch.from_numpy(
            rng.standard_normal((2, cfg.vision_tokens, cfg.d_model))).float()
    logits, caches = m.prefill(params, batch)
    assert logits.shape == (2, 1, cfg.padded_vocab) and torch.isfinite(logits.float()).all()
    assert set(caches) == {"prefix", "groups", "tail"}
    dec = m.make_decode_caches(2, 24, device="cpu")
    logits_d, new = m.decode_step(params, torch.zeros((2, 1), dtype=torch.long), dec, 0)
    assert new["groups"] is dec["groups"]  # written in place
    assert logits_d.shape == (2, 1, cfg.padded_vocab) and torch.isfinite(logits_d.float()).all()


# ------------------------------------------------------------------- layers
def _count_flash(monkeypatch) -> list:
    """Record the shapes of every ``ops.flash_attention`` call."""
    calls, real = [], ops.flash_attention

    def counted(q, k, v, causal=True):
        calls.append((tuple(q.shape), tuple(k.shape), causal))
        return real(q, k, v, causal)

    monkeypatch.setattr(ops, "flash_attention", counted)
    return calls


def _bits_equal(want, got):
    np.testing.assert_array_equal(_f32(got), _f32(want))


def test_rmsnorm_and_rope_bit_equal():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 12, 64)).astype(np.float32)
    sc = rng.standard_normal(64).astype(np.float32)
    _bits_equal(RL.rmsnorm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(sc), 1e-6),
                PL.rmsnorm(torch.from_numpy(x).bfloat16(), torch.from_numpy(sc), 1e-6))
    q = rng.standard_normal((2, 40, 4, 16)).astype(np.float32)
    pos = (np.arange(40)[None] + np.array([[0], [3000]])).astype(np.int32)
    for theta in (10_000.0, 500_000.0, 1_000_000.0):
        _bits_equal(RL.rope(jnp.asarray(q, jnp.bfloat16), jnp.asarray(pos), theta),
                    PL.rope(torch.from_numpy(q).bfloat16(), torch.from_numpy(pos), theta))


def _qkv(seed, sq, sk, h=4, kv=2, d=16):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((2, sq, h, d), (2, sk, kv, d), (2, sk, kv, d))]
    return [jnp.asarray(a, jnp.bfloat16) for a in arrs], [torch.from_numpy(a).bfloat16()
                                                         for a in arrs]


@pytest.mark.parametrize("form", ["decode", "decode_mha", "one_chunk", "one_chunk_bf16",
                                  "unmasked"])
def test_sdpa_bit_equal(form):
    sq, sk, kv = (1, 24, 2) if form.startswith("decode") else (12, 12, 2)
    if form == "decode_mha":
        kv = 4
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, sq, sk, kv=kv)
    if form.startswith("decode"):
        m = np.where(np.random.default_rng(2).random((2, 1, 1, sk)) < 0.7, 0.0, -1e30)
        m = m.astype(np.float32)
    else:
        m = np.array(RL._causal_mask(sq, sk))
        np.testing.assert_array_equal(PL._causal_mask(sq, sk).numpy(), m)
    soft = form == "one_chunk_bf16"
    jm, tm = (None, None) if form == "unmasked" else (jnp.asarray(m), torch.from_numpy(m))
    _bits_equal(RL._sdpa(jq, jk, jv, jm, softmax_bf16=soft),
                PL._sdpa(tq, tk, tv, tm, softmax_bf16=soft))


def test_sdpa_chunked_within_one_ulp():
    """Two chunks of 1024 queries: under 1% of the outputs differ, each by
    at most one bf16 ulp (2**-7 relative) or 2**-10 where the sum cancels
    (measured: 0.07% differ, by at most 2**-11)."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(3, 2048, 2048)
    want = _f32(RL._sdpa(jq, jk, jv, RL._causal_mask(2048, 2048)))
    got = _f32(PL._sdpa(tq, tk, tv, PL._causal_mask(2048, 2048)))
    assert (got != want).mean() < 0.01
    np.testing.assert_allclose(got, want, rtol=2**-7, atol=2**-10)
    with pytest.raises(AssertionError, match="chunk"):
        PL._sdpa(tq[:, :1100], tk[:, :1100], tv[:, :1100], None)  # as the reference asserts


def test_local_mask_equal():
    np.testing.assert_array_equal(PL._local_mask(40, 40, 8).numpy(),
                                  np.asarray(RL._local_mask(40, 40, 8)))


@pytest.mark.parametrize("case", ["prefill_softmax_bf16", "train_local", "train_none",
                                  "prefill_cross", "decode", "decode_masked_update",
                                  "decode_local", "decode_cross"])
def test_attention_layer_bit_equal(case, monkeypatch):
    """One attention layer of reduced llama3-8b, eager on both sides, on the
    ``_sdpa`` route (every case but causal self-attention without
    ``attn_softmax_bf16``): output and cache bit-equal."""
    cfg = RC.reduced_config(RC.ARCHS["llama3-8b"])
    cfg = dataclasses.replace(cfg, attn_softmax_bf16=case == "prefill_softmax_bf16",
                              masked_cache_update=case == "decode_masked_update")
    pcfg = PC.ModelConfig(**dataclasses.asdict(cfg))
    p = RL.attention_init(jax.random.PRNGKey(4), cfg)
    pp = convert.model_params_from_reference(_np(p), device="cpu")
    rng = np.random.default_rng(4)
    decode = case.startswith("decode")
    s = 1 if decode else 12
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    kind = {"local": "local", "none": "none"}.get(case.rsplit("_", 1)[-1], "causal")
    kw = dict(mask_kind=kind, window=5, mode=case.split("_")[0])
    jkw, tkw = {}, {}
    if decode:
        idx, buf = 7, 16
        pos = np.full((2, 1), idx, np.int32)
        k0 = rng.standard_normal((2, buf, cfg.n_kv_heads, 16)).astype(jnp.bfloat16)
        kpos = np.repeat(np.where(np.arange(buf) < idx, np.arange(buf), -1)[None], 2, 0)
        kpos = kpos.astype(np.int32)
        jkw["cache"] = RL.AttnCache(jnp.asarray(k0), jnp.asarray(-k0), jnp.asarray(kpos))
        tkw["cache"] = convert.attn_cache_from_reference(k0, -k0, kpos, device="cpu")
        kw["cache_index"] = idx
        if case == "decode_cross":
            kw["mode"] = "decode_cross"
    else:
        pos = np.broadcast_to(np.arange(s)[None], (2, s)).astype(np.int32)
        if case == "prefill_cross":
            src = rng.standard_normal((2, 10, cfg.d_model)).astype(np.float32)
            jkw["kv_source"] = jnp.asarray(src, jnp.bfloat16)
            tkw["kv_source"] = torch.from_numpy(src).bfloat16()
    want, wc = RL.attention_apply(p, jx, cfg, positions=jnp.asarray(pos), **kw, **jkw)
    flash = _count_flash(monkeypatch)
    got, gc = PL.attention_apply(pp, tx, pcfg, positions=torch.from_numpy(pos), **kw, **tkw)
    assert flash == []
    _bits_equal(want, got)
    assert (wc is None) == (gc is None)
    if case in ("decode", "decode_masked_update", "decode_local"):
        assert gc is tkw["cache"]  # written in place
    if wc is not None:
        for f in ("k", "v", "kpos"):
            _bits_equal(getattr(wc, f), getattr(gc, f))


# -------------------------------------------------------------------- model
def test_loss_forward_matches_reference(pair):
    jt, tt = pair.tokens()
    labels = np.roll(pair.toks, -1, axis=1)
    want, wparts = jax.jit(pair.ref.loss)(pair.params, {"tokens": jt, "labels": jnp.asarray(labels)})
    got, gparts = pair.port.loss(pair.pp, {"tokens": tt, "labels": torch.from_numpy(labels)})
    assert abs(float(got) - float(want)) <= LOSS_TOL
    for k in ("xent", "z_loss", "moe_aux"):
        assert abs(float(gparts[k]) - float(wparts[k])) <= LOSS_TOL
    # the logits of every position, the forward pass the loss reads
    cfg, pcfg, b, s = pair.cfg, pair.pcfg, pair.b, pair.s
    pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[None], (b, s))
    fwd = jax.jit(lambda p, t: RT.logits_from(
        p, RT.apply_stack(p, RT.embed_tokens(p, t, cfg), cfg, mode="train", positions=pos)[0], cfg))
    x, caches, aux = PT.apply_stack(pair.pp, PT.embed_tokens(pair.pp, tt, pcfg), pcfg,
                                    mode="train", positions=_positions(b, s, "cpu"))
    assert caches is None and float(aux) == 0.0
    np.testing.assert_allclose(_f32(PT.logits_from(pair.pp, x, pcfg)), _f32(fwd(pair.params, jt)),
                               **LOGIT_TOL)


def test_prefill_matches_reference(pair, monkeypatch):
    jt, tt = pair.tokens()
    want, wc = jax.jit(pair.ref.prefill)(pair.params, {"tokens": jt})
    flash = _count_flash(monkeypatch)
    got, gc = pair.port.prefill(pair.pp, {"tokens": tt})
    cfg = pair.cfg
    q_shape = (pair.b, pair.s, cfg.n_heads, cfg.resolved_head_dim)
    k_shape = (pair.b, pair.s, cfg.n_kv_heads, cfg.resolved_head_dim)
    assert flash == [(q_shape, k_shape, True)] * cfg.n_layers  # one call a layer
    assert got.shape == (pair.b, 1, pair.cfg.padded_vocab) and got.dtype == torch.bfloat16
    _close_logits(want, got)
    assert gc["prefix"] == [] and gc["tail"] == []
    assert gc["groups"]["pos0"]["self"].k.shape == wc["groups"]["pos0"]["self"].k.shape
    _close_caches(wc, gc)


def test_decode_steps_match_reference(pair, monkeypatch):
    caches = pair.ref.make_decode_caches(pair.b, pair.s + 4)
    pc = convert.decode_caches_from_reference(_np(caches), device="cpu")
    step = jax.jit(pair.ref.decode_step)
    flash = _count_flash(monkeypatch)
    for i in range(pair.s):
        jt, tt = pair.tokens(slice(i, i + 1))
        want, caches = step(pair.params, jt, caches, jnp.asarray(i, jnp.int32))
        got, pc = pair.port.decode_step(pair.pp, tt, pc, i)
        _close_logits(want, got)
    _close_caches(caches, pc)
    assert flash == []  # decode attends through _sdpa


def test_decode_caches_equal_reference_layout():
    m, pm = ref_build(RC.reduced_config(RC.ARCHS["qwen3-0.6b"])), build_model(
        PC.reduced_config(PC.ARCHS["qwen3-0.6b"]))
    want = _np(m.make_decode_caches(3, 24))
    got = pm.make_decode_caches(3, 24, device="cpu")
    w, g = want["groups"]["pos0"]["self"], got["groups"]["pos0"]["self"]
    for f in ("k", "v", "kpos"):
        np.testing.assert_array_equal(_f32(getattr(g, f)), w[f].astype(np.float32))
    assert g.k.dtype == torch.bfloat16 and g.kpos.dtype == torch.int32


# ---------------------------------------- ports of tests/test_models_smoke.py
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_decode_shapes(arch):
    cfg = PC.reduced_config(PC.ARCHS[arch])
    m = build_model(cfg)
    params = m.init(2, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 16)))
    logits, caches = m.prefill(params, {"tokens": toks})
    assert logits.shape == (2, 1, cfg.padded_vocab)
    assert torch.isfinite(logits.float()).all()
    dec = m.make_decode_caches(2, 24, device="cpu")
    logits_d, new = m.decode_step(params, torch.zeros((2, 1), dtype=torch.long), dec, 0)
    assert logits_d.shape == (2, 1, cfg.padded_vocab)
    assert torch.isfinite(logits_d.float()).all()
    assert new["groups"]["pos0"]["self"].kpos[:, :, 0].eq(0).all()


@pytest.mark.parametrize("arch", DENSE)
def test_incremental_decode_matches_full_forward(arch):
    """Decoding the tokens one by one from empty caches reproduces the
    prefill's last-position logits, at the reference test's bound."""
    cfg = PC.reduced_config(PC.ARCHS[arch])
    m = build_model(cfg)
    params = m.init(3, device="cpu")
    b, s = 2, 12
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (b, s)))
    full, _ = m.prefill(params, {"tokens": toks})
    caches = m.make_decode_caches(b, s + 4, device="cpu")
    for i in range(s):
        logits_d, caches = m.decode_step(params, toks[:, i : i + 1], caches, i)
    a, d = _f32(full[:, -1, :]), _f32(logits_d[:, -1, :])
    np.testing.assert_allclose(a, d, atol=0.35, rtol=0.05)
    assert (np.argmax(a, -1) == np.argmax(d, -1)).mean() >= 0.99


def test_reduced_configs_are_small():
    for arch in sorted(PC.ARCHS):
        cfg = PC.reduced_config(PC.ARCHS[arch])
        params = build_model(cfg).init(0, device="cpu")
        n = sum(t.numel() for t in _leaves(params))
        assert n < 5_000_000, f"{arch}: reduced config too big ({n})"
        ref_n = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(
            ref_build(RC.reduced_config(RC.ARCHS[arch])).init(jax.random.PRNGKey(0))))
        assert n == ref_n


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def test_init_draws_the_reference_distributions():
    """Same keys, shapes and dtypes as the reference's init; the draws have
    the reference's scales (normal with std 0.02 for the embeddings,
    fan_in**-0.5 for projections, norms 1)."""
    cfg = PC.reduced_config(PC.ARCHS["llama3-8b"])
    params = build_model(cfg).init(5, device="cpu")
    ref = _np(ref_build(RC.reduced_config(RC.ARCHS["llama3-8b"])).init(jax.random.PRNGKey(5)))

    def walk(g, w):
        if isinstance(w, dict):
            assert set(g) == set(w)
            for k in w:
                walk(g[k], w[k])
        elif isinstance(w, list):
            assert g == [] and w == []
        else:
            assert tuple(g.shape) == w.shape and str(g.dtype).split(".")[-1] == w.dtype.name
    walk(params, ref)
    assert abs(float(params["embed"].std()) - 0.02) < 0.002
    wq = params["groups"]["pos0"]["attn"]["wq"]
    assert abs(float(wq.std()) - cfg.d_model**-0.5) < 0.1 * cfg.d_model**-0.5
    assert torch.equal(params["ln_f"], torch.ones(cfg.d_model))
