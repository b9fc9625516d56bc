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
  The backward: every rank's gradient of x, of the router and of the
  shared expert within (2e-2, 2e-2) of the dense path's, the same on
  every rank (the tokens' and gates' gradients summed over "model", the
  aux's not); each rank's gradient of the expert stacks holds its own
  expert's rows within the same bounds and zeros elsewhere, so no rank
  trains another's expert.

The sharded train step with ``moe_ep`` (``make_train_step`` on a mesh
whose ``"model"`` axis divides the experts: each rank gathers and trains
its own experts), ``tests/torch_tp_case.py``'s EP cases on one launch of
4 gloo ranks:

* ``mla_ep`` (deepseek's reduced config, every expert routed) on 2 x 2: 3
  steps and a prefill against one device within ``FAMILY_BF16`` in
  bfloat16 (measured: gradients 2.0%, params 5.0%, grad norm 5.2e-3 at
  step 3), and in float32 within the dense bounds with the witness
  (gradients, losses, the first grad norm within 1e-5 relative; measured
  1.2e-6, 7.1e-8, 6.3e-8); every rank holds its experts only.
* ``mla_ep_k2`` (its top 2 of 4: the aux loss's gradient reaches the
  router, unsummed over "model") on a (1, 4) model-only mesh in float32:
  the same witness (measured: gradients 1.2e-6).  On more than one data
  rank the reference's EP gradient is the mean of the data shards' aux
  gradients and not one device's (its aux is a product of two means), so
  this case keeps one data rank.
* ``mla_ep_k2`` on (1, 4) in bfloat16, one step against the reference's
  ``make_train_step`` jitted with its shardings on 4 Auto-axis host
  devices: ``tests/test_torch_tensor_parallel.py``'s bounds, and the loss
  and ``moe_aux`` within 1e-3 relative (measured 1.3e-5 and 2.4e-5).  With
  one data rank the two report the same ``moe_aux``; over more the
  reference reports data shard 0's and the port the shards' mean.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.device_mesh import init_device_mesh
from test_torch_tensor_parallel import (F32_REL, finish_reference, hold_to_reference,
                                        start_reference)
from test_torch_tensor_parallel_families import _local_shapes_are_the_specs
from torch_dist_helpers import dist_guard, one_rank, run_ranks  # noqa: F401
from torch_tp_case import STEPS, gaps, setup, within

from repro.configs import ARCHS, reduced_config
from repro.models import layers as RL

import repro_torch.configs as PC
from repro_torch.models import layers as PL
from repro_torch.parallel.sharding import axis_rules, make_rules

TOL = dict(atol=2e-2, rtol=2e-2)
REF_REL = 1e-3  # the loss and moe_aux against the reference's step, relative
# the sharded EP train cases on one launch: name -> (case, compute dtype,
# steps, mesh); "ref" starts from the reference's params
STEP_CASES = {"bf16": ("mla_ep", "bfloat16", STEPS, (2, 2)),
              "f32": ("mla_ep", "float32", STEPS, (2, 2)),
              "k2_f32": ("mla_ep_k2", "float32", STEPS, (1, 4)),
              "ref": ("mla_ep_k2", "bfloat16", 1, (1, 4))}


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
        y, aux, grads = _grads(cfg, p, inp["x"], rules)
        # the expert weights as DTensors split over "model": the same bits
        from torch.distributed.tensor import Replicate, Shard
        from repro_torch.parallel.sharding import place
        pd = {{k: (place(torch.from_numpy(v), mesh, (Replicate(), Shard(0)))
                   if k in ("wg", "wu", "wd") else _torch(v)) for k, v in p.items()}}
        with torch.no_grad(), axis_rules(rules):
            yd, _ = PL.moe_apply(pd, torch.from_numpy(inp["x"]), cfg)
        assert torch.equal(yd, y)
        np.savez(f"{{d}}/out{{rank}}.npz", y=y.float().numpy(), aux=aux.numpy(),
                 **{{f"g{{i}}": g.numpy() for i, g in enumerate(grads)}})
    """, 4, tmp_path)
    y_d, aux_d, g_d = _grads(_port(rc, False), p, x)
    outs = [np.load(tmp_path / f"out{r}.npz") for r in range(4)]
    # x, then the sorted top-level params (router, wd, wg, wu), then the shared expert's
    experts = {2, 3, 4}
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out["y"], outs[0]["y"])
        np.testing.assert_allclose(out["y"], y_d.float().numpy(), **TOL)
        np.testing.assert_array_equal(out["aux"], aux_d.numpy())
        for i, want in enumerate(g_d):
            got, want = out[f"g{i}"], want.numpy()
            if i in experts:  # this rank's expert, and zeros elsewhere
                mine = np.zeros(want.shape[0], bool)
                mine[r] = True
                np.testing.assert_allclose(got[mine], want[mine], **TOL)
                assert not got[~mine].any(), (r, i)
            else:
                np.testing.assert_array_equal(got, outs[0][f"g{i}"])
                np.testing.assert_allclose(got, want, **TOL)


@pytest.fixture(scope="module")
def ep_steps(tmp_path_factory):
    """Every STEP_CASES case on one launch of 4 gloo ranks (the reference's
    step in a subprocess beside them): each case's directory."""
    d = tmp_path_factory.mktemp("ep_steps")
    for name in STEP_CASES:
        (d / name).mkdir()
    ref = start_reference("mla_ep_k2", d / "ref", (1, 4))
    body = "from torch_tp_case import train_rank\n" + "".join(
        f"train_rank(d + '/{name}', rank, {case!r}, {dtype!r}, {steps}, {mesh})\n"
        for name, (case, dtype, steps, mesh) in STEP_CASES.items())
    try:
        run_ranks(body, 4, d)
    finally:
        finish_reference(ref, d / "ref")
    return d


def _outs(d):
    return [np.load(d / f"out{r}.npz") for r in range(4)]


@pytest.mark.parametrize("name", ["bf16", "f32", "k2_f32"])
def test_ep_train_step_on_four_gloo_ranks_matches_one_device(name, ep_steps):
    case, dtype, _, mesh = STEP_CASES[name]
    g = gaps(_outs(ep_steps / name), case, dtype)
    assert within(g, dtype, case), {k: v for k, v in g.items() if k != "local_shapes"}
    if dtype == "float32":
        assert max([g["grad"], *g["loss_rel"], g["gnorm_rel"][0]]) <= F32_REL, g
    model, params, _ = setup(case)
    _local_shapes_are_the_specs(g, model, params, mesh)
    experts = model.cfg.n_experts // mesh[1]
    assert all(shapes["groups.pos0.moe.wg"][1] == experts
               for shapes in g["local_shapes"].values())


def test_ep_train_step_on_a_model_only_mesh_matches_the_references(ep_steps):
    """One step of the top-2 case on (1, 4) against the reference's EP
    step: gradients and params within the dense bounds, the loss and the
    reported moe_aux within REF_REL."""
    got, want = _outs(ep_steps / "ref")[0], np.load(ep_steps / "ref" / "ref_out.npz")
    hold_to_reference(got, want)
    np.testing.assert_allclose(float(got["loss"][0]), float(want["loss"]), rtol=REF_REL)
    np.testing.assert_allclose(float(got["aux"][0]), float(want["aux"]), rtol=REF_REL)
    assert float(want["aux"]) != 1.0  # top 2 of 4: not the constant of routing every expert
