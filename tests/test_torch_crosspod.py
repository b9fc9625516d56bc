"""The port's cross-pod exchange stage (``repro_torch.training.grad_compress.
make_crosspod_exchange``) against the reference's, on the CPU.

* One pod: a (1, 1, 1) ("pod", "data", "model") mesh on one gloo rank,
  in-process, against the reference's stage jitted on its (1, 1, 1) mesh
  (the case of ``tests/test_sharding.py::test_compressed_exchange_math_single_device``,
  plus a leaf whose size is not a multiple of the block and one under
  ``min_leaf_size``), plain and compressed (8 and 4 bits), a leaf at a time
  and flat.  The plain mean is bit-equal; the compressed mean and error
  feedback within 2.5e-7 of the leaf's largest |mean| (two float32 ulps:
  the reference runs jitted and XLA sums the fit's dot over many rows in
  an order of its own, ``tests/test_torch_grad_compress.py``).
* Two pods: a (2, 1, 1) mesh on 2 gloo ranks (subprocesses), the inputs as
  the whole stacked tensor and as a DTensor split over "pod": each rank's
  exchange equals ``compressed_psum_tree`` over the pod group on its own
  pod's gradient (per leaf) and on the concatenation (flat), bit for bit;
  the plain exchange the float32 mean of the two pods' gradients.

The compressed train step on a sharded state (``make_compressed_train_step``
on ("pod", "data", "model") meshes: ``param_specs`` shards replicated over
the pods, the pod's batch over "data", TP over "model", the exchange on
whole blocks of each leaf), ``tests/torch_tp_case.py``'s compressed cases on
one launch of 4 gloo ranks, meshes (2, 2, 1), (2, 1, 2) and (4, 1, 1):

* the exchange on each rank's shards (``compressed_psum_shards``) of
  TINY's leaves and three more (4 blocks split by rows, 2 blocks over
  "model", 16 rows over both axes) equals ``compressed_psum_tree`` on the
  whole leaves over the pod group, mean and error feedback bit for bit, at
  8 and 4 bits;
* 3 steps against the whole-params step (``compressed_psum_tree`` on whole
  gradients, every rank of a pod computing the pod's slice) from the same
  params: within TINY's bounds in bfloat16 (grad norms
  ``COMPRESSED_GNORM_REL``; measured params 3.5%, movement 2.0%, losses
  3.7e-5, grad norms 4.1e-3 at step 3 on (2, 1, 2)), in float32 losses and
  grad norms within 1e-5 (measured 6.9e-7); with one rank a pod bit for bit;
* each rank's first step ran on its own rows of the global batch (pod
  major, then "data"), its loss one device's on those rows (bit for bit
  where "model" is 1), and the params, moments and error feedback come back
  as DTensors placed by ``param_specs``.
"""
import inspect
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP
from torch.distributed.device_mesh import init_device_mesh
from torch_dist_helpers import dist_guard, one_rank, run_ranks  # noqa: F401
from torch_tp_case import COMPRESSED_MESHES, COMPRESSED_WORKER, _no_card, compressed_within

from repro.training import grad_compress as RG

from repro_torch.training import grad_compress as PG
from repro_torch.parallel.sharding import P

SHAPES = {"w": (512, 256), "b": (1000,), "s": (5, 3)}
SHARDED_LEAVES = range(16)  # TINY's 13 leaves and torch_tp_case.EXCHANGE_LEAVES' 3
REL = 2.5e-7


def _grads(seed, pods):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal((pods,) + s).astype(np.float32) * 0.01
            for k, s in SHAPES.items()}


def _ef(seed):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * 1e-4).astype(np.float32) for k, s in SHAPES.items()}


@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("bits", [None, 8, 4])
def test_one_pod_matches_reference_stage(bits, flat, one_rank):
    g, ef = _grads(0, 1), _ef(1)
    kw = dict(bits=bits, min_leaf_size=2000) if bits else None
    rcfg = RG.GradCompressConfig(**kw) if kw else None
    pcfg = PG.GradCompressConfig(**kw) if kw else None
    rmesh = jax.make_mesh((1, 1, 1), ("pod", "data", "model"))
    rspec = {k: JP(*([None] * len(s))) for k, s in SHAPES.items()}
    want, want_ef = jax.jit(RG.make_crosspod_exchange(rmesh, rcfg, rspec, flat=flat))(
        jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, ef))
    mesh = init_device_mesh("cpu", (1, 1, 1), mesh_dim_names=("pod", "data", "model"))
    pspec = {k: P(*([None] * len(s))) for k, s in SHAPES.items()}
    t = lambda tree: {k: torch.from_numpy(v.copy()) for k, v in tree.items()}  # noqa: E731
    got, got_ef = PG.make_crosspod_exchange(mesh, pcfg, pspec, flat=flat)(t(g), t(ef))
    for k in SHAPES:
        scale = np.abs(np.asarray(want[k])).max()
        for a, b in ((got[k], want[k]), (got_ef[k], want_ef[k])):
            a, b = a.to_local().numpy(), np.asarray(b)
            assert a.shape == b.shape
            if bits is None:
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_allclose(a, b, rtol=0, atol=REL * scale)


def test_two_gloo_pods_equal_compressed_psum_tree(tmp_path):
    np.savez(tmp_path / "in.npz", **{f"g:{k}": v for k, v in _grads(2, 2).items()},
             **{f"e:{k}": v for k, v in _ef(3).items()})
    run_ranks("""
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import Replicate, Shard
        from repro_torch.parallel.sharding import P, place
        from repro_torch.training import grad_compress as PG
        from repro_torch.training._tree import tree_map
        inp = np.load(f"{d}/in.npz")
        names = sorted({k.split(":")[1] for k in inp.files})
        g = {k: torch.from_numpy(inp[f"g:{k}"].copy()) for k in names}
        ef = {k: torch.from_numpy(inp[f"e:{k}"].copy()) for k in names}
        mesh = init_device_mesh("cpu", (world, 1, 1), mesh_dim_names=("pod", "data", "model"))
        group = mesh.get_group("pod")
        spec = {k: P(*([None] * (g[k].ndim - 1))) for k in names}
        mine = {k: g[k][rank] for k in names}
        same = lambda a, b: all(torch.equal(a[k], b[k]) for k in names)
        local = lambda tree: {k: v.to_local() for k, v in tree.items()}
        split = {k: place(v, mesh, (Shard(0), Replicate(), Replicate())) for k, v in g.items()}
        for bits in (8, 4):
            cfg = PG.GradCompressConfig(bits=bits, min_leaf_size=2000)
            want, want_ef = PG.compressed_psum_tree(mine, ef, cfg, group=group)
            flat_cfg = PG.GradCompressConfig(bits=bits, min_leaf_size=0)
            cat = lambda tree: {"all": torch.cat([tree[k].reshape(-1) for k in names])}
            fwant, fwant_ef = PG.compressed_psum_tree(cat(mine), cat(ef), flat_cfg, group=group)
            for stacked in (g, split):
                got, got_ef = PG.make_crosspod_exchange(mesh, cfg, spec)(stacked, ef)
                assert same(local(got), want) and same(local(got_ef), want_ef)
                got, got_ef = PG.make_crosspod_exchange(mesh, cfg, spec, flat=True)(stacked, ef)
                assert torch.equal(cat(local(got))["all"], fwant["all"])
                assert torch.equal(cat(local(got_ef))["all"], fwant_ef["all"])
        mean = {k: torch.div(g[k][0] + g[k][1], torch.tensor(2.0)) for k in names}
        for flat in (False, True):
            got, got_ef = PG.make_crosspod_exchange(mesh, None, spec, flat=flat)(split, ef)
            assert same(local(got), mean) and same(local(got_ef), ef)
    """, 2, tmp_path)


def test_parameters_are_the_references():
    want = inspect.signature(RG.make_crosspod_exchange).parameters
    got = inspect.signature(PG.make_crosspod_exchange).parameters
    assert [(p.name, p.kind, p.default) for p in got.values()] == [
        (p.name, p.kind, p.default) for p in want.values()]


@pytest.fixture(scope="module")
def compressed(tmp_path_factory):
    """torch_tp_case's compressed cases on one launch of 4 gloo ranks, in
    bfloat16 and float32: each rank's results by mesh (and dtype)."""
    d = tmp_path_factory.mktemp("compressed")
    with _no_card():
        run_ranks(COMPRESSED_WORKER, 4, d)
    return [json.loads((d / f"compressed{r}.json").read_text()) for r in range(4)]


@pytest.mark.parametrize("mesh", list(COMPRESSED_MESHES))
def test_sharded_exchange_equals_the_whole_leaves(mesh, compressed):
    for out in compressed:
        for dtype in ("", "_float32"):
            for bits in (8, 4):
                e = out[mesh + dtype][f"exchange_bits{bits}"]
                assert e["equal"] == e["leaves"] == len(SHARDED_LEAVES), (mesh, bits, e)


@pytest.mark.parametrize("mesh", ["pod2_data2", "pod2_model2"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_sharded_compressed_step_matches_the_whole_params_step(mesh, dtype, compressed):
    key = mesh + ("" if dtype == "bfloat16" else "_float32")
    for out in compressed:
        assert compressed_within(out[key], dtype), out[key]
        # every rank the same gaps: the same whole state and metrics
        same = lambda r: {k: v for k, v in r.items() if k != "loss_of_its_rows_rel"}  # noqa: E731
        assert same(out[key]) == same(compressed[0][key])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_one_rank_a_pod_is_the_whole_params_step(dtype, compressed):
    key = "pod4" + ("" if dtype == "bfloat16" else "_float32")
    assert all(out[key]["bit_equal"] and compressed_within(out[key], dtype)
               for out in compressed)


@pytest.mark.parametrize("mesh", list(COMPRESSED_MESHES))
def test_each_rank_trains_on_its_own_rows(mesh, compressed):
    for out in compressed:
        for dtype in ("", "_float32"):
            res = out[mesh + dtype]
            assert res["rows_are_this_ranks"] and res["placed_as_specs"]
            if COMPRESSED_MESHES[mesh][2] == 1:
                assert res["loss_of_its_rows_rel"] == 0.0
            else:  # heads split over "model": the rounding of split contractions
                assert res["loss_of_its_rows_rel"] < 1e-4
