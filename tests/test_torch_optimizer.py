"""The port's AdamW (``repro_torch.training.optimizer``) against the
reference's, on the CPU, on identical inputs (numpy from a seed, through
both packages).

Tolerances and why:

* ``adamw_update`` over 5 steps on identical grads: the first and second
  moments and the step equal bit for bit; the schedule's learning rate
  too.  float32 params within 2.5e-7 absolute (one float32 ulp at |p| < 4:
  measured 3e-8, where XLA's CPU code and torch round one element of the
  update another way); bf16 params bit for bit.
* ``global_norm`` and ``clip_by_global_norm``: within 2 ulps of the norm
  (rtol 3e-7): XLA and torch sum a leaf's squares in other orders.
* ``_schedule`` at every step of a warmup and a cosine decay: within two
  float32 ulps (``cos`` may round another way, and the products after it
  carry that; measured 2 at one step of 20).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import optimizer as RO

from repro_torch.training import optimizer as PO
from repro_torch.training._tree import leaves, tree_map, unflatten

CFG = dict(lr=1e-2, warmup_steps=3, decay_steps=10)


def _tree(rng, dtype=np.float32):
    f = lambda s: rng.standard_normal(s).astype(dtype)
    return {"b": [f((7,)), f((300,))], "a": f((64, 33)), "c": {"z": f((5, 5)), "y": None}}


def _to_jax(tree, dtype=None):
    return jax.tree.map(lambda a: jnp.asarray(a) if dtype is None else jnp.asarray(a).astype(dtype),
                        tree)


def _to_torch(tree, dtype=None):
    return tree_map(lambda a: torch.from_numpy(a.copy()) if dtype is None
                    else torch.from_numpy(a.copy()).to(dtype), tree)


def test_leaves_follow_jax_order():
    tree = _tree(np.random.default_rng(0))
    want = jax.tree.leaves(tree)
    got = leaves(tree)
    assert len(got) == len(want) == 4
    assert all(a is b for a, b in zip(got, want))
    rebuilt = unflatten(tree, [x * 2 for x in got])
    assert list(rebuilt) == list(tree) and rebuilt["c"]["y"] is None
    np.testing.assert_array_equal(rebuilt["a"], tree["a"] * 2)
    with pytest.raises(ValueError):
        unflatten(tree, got + got[:1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_five_steps_matches_reference(dtype):
    rng = np.random.default_rng(1)
    p0 = _tree(rng)
    rp, tp = _to_jax(p0, dtype), _to_torch(p0, getattr(torch, dtype))
    rs, ts = RO.adamw_init(rp), PO.adamw_init(tp)
    assert ts["step"].dtype == torch.int32 and all(m.dtype == torch.float32
                                                   for m in leaves(ts["m"]))
    for _ in range(5):
        g = _tree(rng)
        rp, rs = RO.adamw_update(RO.AdamWConfig(**CFG), rp, _to_jax(g), rs)
        tp, ts = PO.adamw_update(PO.AdamWConfig(**CFG), tp, _to_torch(g), ts)
        assert int(rs["step"]) == int(ts["step"])
        for a, b in zip(jax.tree.leaves(rs["m"]) + jax.tree.leaves(rs["v"]),
                        leaves(ts["m"]) + leaves(ts["v"])):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        for a, b in zip(jax.tree.leaves(rp), leaves(tp)):
            assert b.dtype == getattr(torch, dtype)
            a, b = np.asarray(a.astype(jnp.float32)), b.float().numpy()
            if dtype == "bfloat16":
                np.testing.assert_array_equal(b, a)
            else:
                np.testing.assert_allclose(b, a, rtol=0, atol=2.5e-7)


def test_clip_by_global_norm_matches_reference():
    rng = np.random.default_rng(2)
    g = _tree(rng)
    for max_norm in (1.0, 1e3):
        rg, rn = RO.clip_by_global_norm(_to_jax(g), max_norm)
        tg, tn = PO.clip_by_global_norm(_to_torch(g), max_norm)
        np.testing.assert_allclose(float(tn), float(rn), rtol=3e-7)
        np.testing.assert_allclose(float(PO.global_norm(_to_torch(g))), float(rn), rtol=3e-7)
        for a, b in zip(jax.tree.leaves(rg), leaves(tg)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=6e-7, atol=0)


@pytest.mark.parametrize("decay_steps", [10, 0])
def test_schedule_matches_reference(decay_steps):
    rc = RO.AdamWConfig(lr=3e-4, warmup_steps=4, decay_steps=decay_steps)
    pc = PO.AdamWConfig(lr=3e-4, warmup_steps=4, decay_steps=decay_steps)
    for s in range(0, 20):
        want = float(RO._schedule(rc, jnp.asarray(s, jnp.int32)))
        got = float(PO._schedule(pc, torch.tensor(s, dtype=torch.int32)))
        assert abs(got - want) <= 2 * np.spacing(np.float32(want)), (s, got, want)
