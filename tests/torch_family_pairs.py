"""Shared helpers of the model-family parity tests
(``tests/test_torch_models_{moe,recurrent,cross}.py``): one arch at its
reduced config on both sides, its seeded batch, and the checks of loss,
prefill, decode steps and incremental decode at the bounds of
``tests/test_torch_models.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as RC
from repro.models import build_model as ref_build
from test_torch_models import CACHE_TOL, LOSS_TOL, _close_logits, _f32, _np

import repro_torch.configs as PC
from repro_torch import convert
from repro_torch.models import build_model


def make_batch(cfg, b=2, s=16, seed=0) -> dict:
    """The reference smoke test's batch as numpy: tokens and labels; an
    encoder-decoder's frames take the first half of ``s``, a VLM adds its
    vision embeddings."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    if cfg.family == "encdec":
        se = s // 2
        frames = rng.standard_normal((b, se, cfg.d_model)).astype(np.float32)
        return {"frames": frames, "tokens": toks[:, : s - se],
                "labels": np.roll(toks[:, : s - se], -1, axis=1)}
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if cfg.family == "vlm":
        batch["vision"] = rng.standard_normal((b, cfg.vision_tokens, cfg.d_model)).astype(
            np.float32)
    return batch


def to_jax(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in batch.items()}


class FamilyPair:
    """One arch at its reduced config (with ``changes`` applied on both
    sides): the reference model and params, the port's model and the
    converted params, and a seeded batch."""

    def __init__(self, arch: str, changes=None, seed: int = 0, b: int = 2, s: int = 16):
        cfg = RC.reduced_config(RC.ARCHS[arch])
        self.cfg = dataclasses.replace(cfg, **(changes or {}))
        self.pcfg = PC.ModelConfig(**dataclasses.asdict(self.cfg))
        self.ref, self.port = ref_build(self.cfg), build_model(self.pcfg)
        self.params = self.ref.init(jax.random.PRNGKey(seed))
        self.pp = convert.model_params_from_reference(_np(self.params), device="cpu")
        self.batch = make_batch(self.cfg, b, s, seed)
        self.b = b


def close_caches(want, got):
    """Walk a reference cache tree (dataclasses) and the port's: the same
    structure and shapes; float fields within CACHE_TOL, positions equal."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want)
        for k in want:
            close_caches(want[k], got[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for w, g in zip(want, got):
            close_caches(w, g)
    else:
        assert type(got).__name__ == type(want).__name__
        for f in dataclasses.fields(want):
            w, g = np.asarray(getattr(want, f.name)), getattr(got, f.name)
            assert tuple(g.shape) == w.shape, f.name
            if f.name == "kpos":
                np.testing.assert_array_equal(g.numpy(), w)
            else:
                np.testing.assert_allclose(_f32(g), w.astype(np.float32), **CACHE_TOL)


def check_loss(pair: FamilyPair):
    want, wparts = jax.jit(pair.ref.loss)(pair.params, to_jax(pair.batch))
    got, gparts = pair.port.loss(pair.pp, to_torch(pair.batch))
    assert abs(float(got) - float(want)) <= LOSS_TOL
    for k in ("xent", "z_loss", "moe_aux"):
        assert abs(float(gparts[k]) - float(wparts[k])) <= LOSS_TOL
    if pair.cfg.n_experts:
        assert float(gparts["moe_aux"]) > 0


def first_groups(caches: dict, n: int) -> dict:
    """The cache tree with its stacked groups cut to the first ``n``."""
    def cut(t):
        if isinstance(t, dict):
            return {k: cut(v) for k, v in t.items()}
        return type(t)(*(getattr(t, f.name)[:n] for f in dataclasses.fields(t)))
    return dict(caches, groups=cut(caches["groups"]))


def check_prefill(pair: FamilyPair, cache_groups=None):
    """Logits and caches of a prefill; ``cache_groups`` holds only the
    first that many stacked groups' caches (with the prefix and tail)."""
    want, wc = jax.jit(pair.ref.prefill)(pair.params, to_jax(pair.batch))
    got, gc = pair.port.prefill(pair.pp, to_torch(pair.batch))
    assert got.shape == (pair.b, 1, pair.cfg.padded_vocab) and got.dtype == torch.bfloat16
    _close_logits(want, got)
    if cache_groups is not None:
        wc, gc = first_groups(wc, cache_groups), first_groups(gc, cache_groups)
    close_caches(wc, gc)


def graft_cross(dec, pref):
    """Copy the prefill-built cross caches into fresh decode caches (the
    reference test's ``_graft_cross``)."""
    if isinstance(dec, dict):
        return {k: (pref[k] if k == "cross" else graft_cross(dec[k], pref[k])) for k in dec}
    if isinstance(dec, list):
        return [graft_cross(d, p) for d, p in zip(dec, pref)]
    return dec


def check_decode_steps(pair: FamilyPair, steps: int = 8):
    """Reference decode steps against the port's from the same caches (the
    reference's empty caches with the cross caches of a reference prefill
    grafted in), logits each step and the caches after."""
    toks = pair.batch["tokens"]
    n = min(steps, toks.shape[1])
    caches = pair.ref.make_decode_caches(pair.b, n + 4)
    if pair.cfg.family in ("vlm", "encdec"):
        first = dict(to_jax(pair.batch), tokens=jnp.asarray(toks[:, :1]))
        _, pref = jax.jit(pair.ref.prefill)(pair.params, first)
        caches = graft_cross(caches, pref)
    pc = convert.decode_caches_from_reference(_np(caches), device="cpu")
    step = jax.jit(pair.ref.decode_step)
    for i in range(n):
        t = toks[:, i : i + 1]
        want, caches = step(pair.params, jnp.asarray(t), caches, jnp.asarray(i, jnp.int32))
        got, pc = pair.port.decode_step(pair.pp, torch.from_numpy(t).long(), pc, i)
        _close_logits(want, got)
    close_caches(caches, pc)


def check_incremental_decode(arch: str, changes=None):
    """The port alone: decoding the tokens one by one from empty caches (a
    VLM's and an encoder-decoder's cross caches grafted from a prefill of
    the first token) reproduces the prefill's last-position logits, at the
    reference test's bound."""
    cfg = dataclasses.replace(PC.reduced_config(PC.ARCHS[arch]), **(changes or {}))
    m = build_model(cfg)
    params = m.init(3, device="cpu")
    batch = to_torch(make_batch(cfg, b=2, s=12, seed=3))
    toks = batch["tokens"]
    n_dec = toks.shape[1]
    full, _ = m.prefill(params, batch)
    caches = m.make_decode_caches(2, n_dec + 4, device="cpu")
    if cfg.family in ("encdec", "vlm"):
        _, pref = m.prefill(params, dict(batch, tokens=toks[:, :1]))
        caches = graft_cross(caches, pref)
    for i in range(n_dec):
        logits_d, caches = m.decode_step(params, toks[:, i : i + 1], caches, i)
    a, d = _f32(full[:, -1, :]), _f32(logits_d[:, -1, :])
    np.testing.assert_allclose(a, d, atol=0.35, rtol=0.05)
    assert (np.argmax(a, -1) == np.argmax(d, -1)).mean() >= 0.99
