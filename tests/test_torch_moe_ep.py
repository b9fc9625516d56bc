"""The port's expert-parallel MoE (``repro_torch.models.layers``, the
reference's ``_moe_apply_ep``) against the dense ``moe_apply`` of both
packages, on the CPU.

The reference's own ``test_moe_ep_matches_dense_path`` fails under this
JAX, so the dense paths are the oracle.  The case is the reference test's:
deepseek-v2-lite-16b's reduced config (4 experts, top-2, d 64, one shared
expert) without its dense first layer, x [2, 16, d] float32, params drawn
by the reference and converted; at its dropless capacity factor 8 and at
1.25, which drops tokens (the positions within an expert are the same
token order on both routes, so the same tokens drop).

* A 1 x 1 ("data", "model") mesh on one gloo rank, in-process: the EP
  output and aux equal the port's dense path bit for bit, and so do the
  gradients of x and of every param; against the reference's dense path
  within the reference test's (2e-2, 2e-2), aux within rtol 1e-4.
* A 1 x 4 mesh on 4 gloo ranks (subprocesses), one expert a rank: every
  rank's output within (2e-2, 2e-2) of the port's dense path (the ranks'
  bf16 partial outputs summed by gloo, in another order than the dense
  path's slot order), the same on every rank; aux bit-equal; the expert
  weights given as DTensors split over "model" give the same output bits.
  Over more than one model rank the EP MoE runs forward only (prefill,
  decode), so a call that records a gradient raises.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch_dist_helpers import dist_guard, one_rank, run_ranks  # noqa: F401

from repro.configs import ARCHS, reduced_config
from repro.models import layers as RL

import repro_torch.configs as PC
from repro_torch.models import layers as PL
from repro_torch.parallel.sharding import axis_rules, make_rules

TOL = dict(atol=2e-2, rtol=2e-2)


def _case(cf: float):
    rc = dataclasses.replace(reduced_config(ARCHS["deepseek-v2-lite-16b"]),
                             capacity_factor=cf, first_dense_layers=0)
    p = RL.moe_init(jax.random.PRNGKey(0), rc)
    x = np.random.default_rng(0).standard_normal((2, 16, rc.d_model)).astype(np.float32)
    return rc, jax.tree.map(np.asarray, p), x


def _port(cfg_ref, ep: bool):
    return PC.ModelConfig(**dataclasses.asdict(dataclasses.replace(cfg_ref, moe_ep=ep)))


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).requires_grad_(True)


def _grads(cfg, p, x, rules=None):
    p, x = _torch(p), torch.from_numpy(x).requires_grad_(True)
    with axis_rules(rules):
        y, aux = PL.moe_apply(p, x, cfg)
    flat = [x] + [p[k] for k in sorted(p) if k != "shared"] + [
        p["shared"][k] for k in sorted(p["shared"])]
    grads = torch.autograd.grad((y.float() ** 2).sum() + aux, flat)
    return y.detach(), aux.detach(), grads


@pytest.mark.parametrize("cf", [8.0, 1.25])
def test_ep_on_one_rank_equals_the_dense_paths(cf, one_rank):
    rc, p, x = _case(cf)
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    y_ep, aux_ep, g_ep = _grads(_port(rc, True), p, x, make_rules(mesh, _port(rc, True)))
    y_d, aux_d, g_d = _grads(_port(rc, False), p, x)
    assert torch.equal(y_ep, y_d) and torch.equal(aux_ep, aux_d)
    assert all(torch.equal(a, b) for a, b in zip(g_ep, g_d))
    y_ref, aux_ref = RL.moe_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x), rc)
    np.testing.assert_allclose(y_ep.float().numpy(), np.asarray(y_ref, np.float32), **TOL)
    np.testing.assert_allclose(float(aux_ep), float(aux_ref), rtol=1e-4)


@pytest.mark.parametrize("cf", [8.0, 1.25])
def test_ep_on_four_gloo_ranks_matches_the_dense_path(cf, tmp_path):
    rc, p, x = _case(cf)
    flat = {"x": x, **{f"p:{k}": v for k, v in p.items() if k != "shared"},
            **{f"s:{k}": v for k, v in p["shared"].items()}}
    np.savez(tmp_path / "in.npz", **flat)
    run_ranks(f"""
        import dataclasses
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.configs import get_config
        import repro_torch.configs as PC
        from repro_torch.models import layers as PL
        from repro_torch.parallel.sharding import axis_rules, make_rules
        from test_torch_moe_ep import _grads, _torch
        inp = np.load(f"{{d}}/in.npz")
        p = {{k[2:]: inp[k] for k in inp.files if k.startswith("p:")}}
        p["shared"] = {{k[2:]: inp[k] for k in inp.files if k.startswith("s:")}}
        cfg = PC.ModelConfig(**{dataclasses.asdict(_port(rc, True))!r})
        mesh = init_device_mesh("cpu", (1, world), mesh_dim_names=("data", "model"))
        rules = make_rules(mesh, cfg)
        try:  # forward only over more than one model rank
            _grads(cfg, p, inp["x"], rules)
            raise AssertionError("the EP MoE recorded a gradient over 4 model ranks")
        except ValueError as err:
            assert "forward only" in str(err)
        x = torch.from_numpy(inp["x"])
        with torch.no_grad(), axis_rules(rules):
            y, aux = PL.moe_apply(_torch(p), x, cfg)
        # the expert weights as DTensors split over "model": the same bits
        from torch.distributed.tensor import Replicate, Shard
        from repro_torch.parallel.sharding import place
        pd = {{k: (place(torch.from_numpy(v), mesh, (Replicate(), Shard(0)))
                   if k in ("wg", "wu", "wd") else _torch(v)) for k, v in p.items()}}
        with torch.no_grad(), axis_rules(rules):
            yd, _ = PL.moe_apply(pd, x, cfg)
        assert torch.equal(yd, y)
        np.savez(f"{{d}}/out{{rank}}.npz", y=y.float().numpy(), aux=aux.numpy())
    """, 4, tmp_path)
    y_d, aux_d, _ = _grads(_port(rc, False), p, x)
    outs = [np.load(tmp_path / f"out{r}.npz") for r in range(4)]
    for out in outs:
        np.testing.assert_array_equal(out["y"], outs[0]["y"])
        np.testing.assert_allclose(out["y"], y_d.float().numpy(), **TOL)
        np.testing.assert_array_equal(out["aux"], aux_d.numpy())
