"""The port's training step (``repro_torch.training.train_step``, the
models' backward pass, the flash-attention gradient) against the
reference, on the CPU, with params converted from the reference's
(``convert.model_params_from_reference``) and batches from the ported
``TokenPipeline``.

The reference's ``make_train_step`` cannot run on ``jax.make_mesh``'s
default Explicit axes (its mesh rules raise at ``shard()``, ROADMAP queue
3; ``tests/test_torch_mesh.py`` runs it on Auto axes), so here the port
is held against ``jax.value_and_grad(model.loss)``,
``clip_by_global_norm`` and ``adamw_update`` called directly.

Tolerances and why:

* the loss within 0.01 (measured at most 1.3e-4), as
  ``tests/test_torch_models.py`` holds the forward;
* each parameter's gradient within 6% of that leaf's largest |gradient|
  (measured at most 3.1%, qwen3's ``q_norm``): the reference compiles
  its backward and keeps some bf16 intermediates in float32, the port
  rounds each op to bf16, and its attention takes the flash route's
  float32 probabilities where the reference rounds them to bf16;
* one full step (clip, AdamW): the grad norm within 2%, each param within
  2.1 x the step's learning rate (AdamW's first update is about
  lr x sign(g), so a gradient element near zero may take either sign);
* the flash backward's plain version against ``jax.vjp`` of the
  reference's oracle ``flash_attention_ref`` head by head, float32:
  within 2e-5 of the largest |gradient| (measured under 1e-6);
* remat on and off: equal gradients, bit for bit (the recomputed forward
  is the same ops on the same inputs).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.kernels import ref as kref
from repro.models import build_model as ref_build
from repro.training import optimizer as RO

import repro_torch.configs as PC
from repro_torch import convert
from repro_torch.core.errors import ConfigError
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import build_model
from repro_torch.training import AdamWConfig, adamw_init, make_train_step
from repro_torch.training._tree import leaves
from repro_torch.training.train_step import _value_and_grad

TINY = dict(name="lm-tiny", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            d_ff=256, vocab_size=512, head_dim=16, tie_embeddings=True)  # tests/test_system.py
LOSS_TOL = 0.01
GRAD_REL = 0.06


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    return np.asarray(tree)


def _configs(name):
    rc = RC.ModelConfig(**TINY) if name == "lm-tiny" else RC.reduced_config(
        RC.get_config("qwen3-0.6b"))
    return rc, PC.ModelConfig(**dataclasses.asdict(rc))


@pytest.fixture(scope="module", params=["lm-tiny", "qwen3-0.6b"])
def pair(request):
    rc, pc = _configs(request.param)
    rm, pm = ref_build(rc), build_model(pc)
    rp = rm.init(jax.random.PRNGKey(0))
    pp = convert.model_params_from_reference(_np(rp), device="cpu")
    batch = TokenPipeline(vocab_size=rc.vocab_size, batch=2, seq_len=64, seed=3).batch_at(0)
    (loss, parts), grads = jax.value_and_grad(rm.loss, has_aux=True)(
        rp, jax.tree.map(jnp.asarray, batch))
    return pm, rp, pp, batch, (loss, parts, grads)


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def test_loss_and_every_gradient_match_reference(pair):
    pm, rp, pp, batch, (rl, rparts, rg) = pair
    pl, pparts, pg = _value_and_grad(pm, pp, _torch_batch(batch))
    assert abs(float(pl) - float(rl)) < LOSS_TOL
    for k in ("xent", "z_loss", "moe_aux"):
        assert abs(float(pparts[k]) - float(rparts[k])) < LOSS_TOL
    ref_leaves = jax.tree_util.tree_flatten_with_path(rg)[0]
    assert len(ref_leaves) == len(leaves(pg))
    for (path, a), g in zip(ref_leaves, leaves(pg)):
        a = np.asarray(a, np.float32)
        g = g.float().numpy()
        assert g.shape == a.shape and np.isfinite(g).all()
        err = np.abs(g - a).max()
        assert err <= GRAD_REL * np.abs(a).max(), (jax.tree_util.keystr(path), err)


def test_one_full_step_matches_reference(pair):
    pm, rp, pp, batch, (rl, _, rg) = pair
    cfg = dict(lr=1e-3, warmup_steps=2, decay_steps=10)
    rg, rn = RO.clip_by_global_norm(rg, 1.0)
    rp2, rs = RO.adamw_update(RO.AdamWConfig(**cfg), rp, rg, RO.adamw_init(rp))
    step = make_train_step(pm, None, AdamWConfig(**cfg))
    pp2, ps, metrics = step(pp, adamw_init(pp), _torch_batch(batch))
    assert set(metrics) == {"loss", "grad_norm", "xent", "z_loss", "moe_aux"}
    assert abs(float(metrics["loss"]) - float(rl)) < LOSS_TOL
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(rn), rtol=0.02)
    lr = float(RO._schedule(RO.AdamWConfig(**cfg), rs["step"]))
    assert int(ps["step"]) == int(rs["step"]) == 1
    for a, b in zip(jax.tree.leaves(rp2), leaves(pp2)):
        np.testing.assert_allclose(b.float().numpy(), np.asarray(a, np.float32), rtol=0,
                                   atol=2.1 * lr)
    # the caller's params are untouched and carry no graph
    assert all(not p.requires_grad for p in leaves(pp) + leaves(pp2))


def test_remat_on_and_off_give_equal_gradients():
    _, pc = _configs("qwen3-0.6b")
    m_on = build_model(dataclasses.replace(pc, remat=True))
    m_off = build_model(dataclasses.replace(pc, remat=False))
    params = m_on.init(0, device="cpu")
    batch = _torch_batch(TokenPipeline(vocab_size=pc.vocab_size, batch=2, seq_len=32).batch_at(1))
    l1, _, g1 = _value_and_grad(m_on, params, batch)
    l2, _, g2 = _value_and_grad(m_off, params, batch)
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(leaves(g1), leaves(g2)))


def test_dots_remat_policy_raises_config_error():
    """``remat_policy="dots"`` (save the 2-D matmuls, recompute the rest)
    gives the loss, the gradients and one step's params of ``"nothing"``
    bit for bit, on lm-tiny and on reduced qwen3; a policy of neither name
    raises ``ConfigError``."""
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, decay_steps=10)
    for name in ("lm-tiny", "qwen3-0.6b"):
        _, pc = _configs(name)
        m_dots = build_model(dataclasses.replace(pc, remat=True, remat_policy="dots"))
        m_none = build_model(dataclasses.replace(pc, remat=True, remat_policy="nothing"))
        params = m_dots.init(0, device="cpu")
        batch = _torch_batch(TokenPipeline(vocab_size=pc.vocab_size, batch=2,
                                           seq_len=32).batch_at(1))
        l1, p1, g1 = _value_and_grad(m_dots, params, batch)
        l2, p2, g2 = _value_and_grad(m_none, params, batch)
        assert torch.equal(l1, l2) and all(torch.equal(p1[k], p2[k]) for k in p2)
        assert all(torch.equal(a, b) for a, b in zip(leaves(g1), leaves(g2)))
        s1 = make_train_step(m_dots, None, opt)(params, adamw_init(params), batch)
        s2 = make_train_step(m_none, None, opt)(params, adamw_init(params), batch)
        assert all(torch.equal(a, b) for a, b in zip(leaves(s1[:2]), leaves(s2[:2])))
    m = build_model(dataclasses.replace(pc, remat=True, remat_policy="everything"))
    with pytest.raises(ConfigError, match="remat_policy"):
        _value_and_grad(m, params, batch)
    with torch.no_grad():  # the forward alone has nothing to recompute
        m.loss(params, batch)


def test_lm_tiny_loss_falls_over_40_steps():
    """The reference's ``test_loss_decreases`` on the port."""
    _, pc = _configs("lm-tiny")
    model = build_model(pc)
    params = model.init(0, device="cpu")
    step = make_train_step(model, None, AdamWConfig(lr=2e-3, warmup_steps=5, decay_steps=60))
    pipe = TokenPipeline(vocab_size=pc.vocab_size, batch=4, seq_len=64, seed=11)
    opt = adamw_init(params)
    losses = []
    for s in range(40):
        params, opt, metrics = step(params, opt, _torch_batch(pipe.batch_at(s)))
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3, losses


@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_plain_matches_reference_oracle(causal):
    rng = np.random.default_rng(4)
    b, sq, sk, h, kvh, d = 2, 40, 40 if causal else 29, 4, 2, 16
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, kvh, d)).astype(np.float32)
    do = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    out = FA.flash_attention(*t[:3], causal=causal)
    dq, dk, dv = FA.flash_attention_bwd(*t[:3], out, t[3], causal)
    rep = h // kvh
    want_dk = np.zeros_like(k)
    want_dv = np.zeros_like(v)
    for bi in range(b):
        for hi in range(h):
            g = hi // rep
            _, vjp = jax.vjp(lambda a, c, e: kref.flash_attention_ref(a, c, e, causal),
                             q[bi, :, hi], k[bi, :, g], v[bi, :, g])
            wq, wk, wv = (np.asarray(x) for x in vjp(jnp.asarray(do[bi, :, hi])))
            np.testing.assert_allclose(dq[bi, :, hi].numpy(), wq, rtol=0,
                                       atol=2e-5 * np.abs(wq).max())
            want_dk[bi, :, g] += wk
            want_dv[bi, :, g] += wv
    for got, want in ((dk, want_dk), (dv, want_dv)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5 * np.abs(want).max())
