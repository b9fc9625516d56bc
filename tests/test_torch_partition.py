"""The port's spec functions (``repro_torch.parallel.partition`` and the
spec maps of ``repro_torch.training.train_step``) against the reference's,
on the CPU, for every config at its full shapes.

The reference's trees come from ``jax.eval_shape`` (``Model.init_shapes``,
``make_decode_caches``); the port's are the same shapes as
``torch.empty(shape, device="meta")`` leaves, so no weight is allocated.
The meshes are abstract (names and sizes, no process group): the
production (16, 16) ("data", "model") and (2, 16, 16) ("pod", "data",
"model"), each config also with ``dcn_fsdp`` on the second.  Specs are
compared leaf by leaf by path, as ``tuple(spec)``, which must be equal.
``param_shardings`` is checked on a one-rank gloo mesh: each leaf's
placements are its spec's.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard
from torch_dist_helpers import dist_guard, one_rank  # noqa: F401

from repro.configs import ARCHS
from repro.models import build_model as ref_build
from repro.parallel import partition as RPt
from repro.parallel.sharding import abstract_mesh as ref_abstract_mesh
from repro.training import train_step as RT

import repro_torch.configs as PC
from repro_torch.models import build_model
from repro_torch.models import transformer as T
from repro_torch.parallel import partition as PPt
from repro_torch.parallel.sharding import P, abstract_mesh, tree_map_with_path
from repro_torch.training import train_step as PT

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
CASES = [(arch, mesh, dcn) for arch in ARCHS for mesh in MESHES
         for dcn in ((False, True) if mesh == "2x16x16" else (False,))]


def _key(entry):
    for attr in ("key", "idx", "name"):
        if hasattr(entry, attr):
            return getattr(entry, attr)
    raise TypeError(entry)


def _ref_specs(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {tuple(_key(e) for e in path): tuple(spec) for path, spec in flat}


def _port_specs(tree) -> dict:
    out = {}

    def visit(path, spec):
        assert isinstance(spec, P)
        out[path] = tuple(spec)

    tree_map_with_path(visit, tree)
    return out


def _meta(tree):
    """The reference's shape tree as the port's tree of meta tensors."""
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_meta(v) for v in tree)
    return torch.empty(tuple(tree.shape), device="meta")


def _configs(arch, dcn):
    rc = ARCHS[arch]
    rc = dataclasses.replace(rc, dcn_fsdp=rc.dcn_fsdp or dcn)
    return rc, PC.ModelConfig(**dataclasses.asdict(rc))


def _meshes(name):
    sizes, names = MESHES[name]
    return ref_abstract_mesh(sizes, names), abstract_mesh(sizes, names)


@pytest.mark.parametrize("arch,mesh,dcn", CASES)
def test_param_and_state_specs_match_reference(arch, mesh, dcn):
    rc, pc = _configs(arch, dcn)
    rmesh, pmesh = _meshes(mesh)
    shapes = ref_build(rc).init_shapes()
    params = _meta(shapes)
    assert PPt.fsdp_axes_for(pc, pmesh) == RPt.fsdp_axes_for(rc, rmesh)
    for vocab in (True, False):
        want = _ref_specs(RPt.param_specs(shapes, rc, rmesh, vocab_dim_sharded=vocab))
        got = _port_specs(PPt.param_specs(params, pc, pmesh, vocab_dim_sharded=vocab))
        assert got == want
    want = _ref_specs(RT.train_state_specs(shapes, rc, rmesh))
    assert _port_specs(PT.train_state_specs(params, pc, pmesh)) == want


@pytest.mark.parametrize("arch", list(ARCHS))
def test_cache_and_batch_specs_match_reference(arch):
    rc, pc = _configs(arch, False)
    rm, pm = ref_build(rc), build_model(pc)
    caches = jax.eval_shape(lambda: rm.make_decode_caches(16, 4096))
    mine = T.make_decode_caches(pc, 16, 4096, pm._cross_len(4096), torch.device("meta"))
    for mesh in MESHES:
        rmesh, pmesh = _meshes(mesh)
        batch_axes = tuple(a for a in ("pod", "data") if a in MESHES[mesh][1])
        for axes in (batch_axes, batch_axes[-1]):
            want = _ref_specs(RT.cache_specs(caches, rmesh, axes))
            assert _port_specs(PT.cache_specs(mine, pmesh, axes)) == want
            want = _ref_specs(RT.cache_specs(caches, rmesh, axes, seq_axis=None))
            assert _port_specs(PT.cache_specs(mine, pmesh, axes, seq_axis=None)) == want
            for b in (1, 16, 64):
                batch = {"tokens": jax.ShapeDtypeStruct((b, 128), jnp.int32),
                         "labels": jax.ShapeDtypeStruct((b, 128), jnp.int32),
                         "scale": jax.ShapeDtypeStruct((), jnp.float32)}
                want = _ref_specs(RT.batch_specs(batch, rmesh, axes))
                assert _port_specs(PT.batch_specs(_meta(batch), pmesh, axes)) == want


def test_shardings_are_the_specs_placements(one_rank):
    mesh = init_device_mesh("cpu", (1, 1, 1), mesh_dim_names=("pod", "data", "model"))
    rc, pc = _configs("deepseek-v2-lite-16b", False)
    params = _meta(ref_build(rc).init_shapes())
    specs = PPt.param_specs(params, pc, mesh)
    shardings = PPt.param_shardings(params, pc, mesh)
    seen = []

    def check(path, spec):
        node = shardings
        for k in path:
            node = node[k]
        got_mesh, placements = node
        assert got_mesh is mesh and len(placements) == 3
        for axis, pl in zip(("pod", "data", "model"), placements):
            dims = [d for d, part in enumerate(spec)
                    if part == axis or (isinstance(part, tuple) and axis in part)]
            assert pl == (Shard(dims[0]) if dims else Replicate())
        seen.append(path)

    tree_map_with_path(check, specs)
    assert seen and any(isinstance(p, Shard) for p in shardings["embed"].placements)
    # the expert weights' experts lie over "model" (3-D rule under "moe")
    assert shardings["groups"]["pos0"]["moe"]["wg"].placements[2] == Shard(1)


def test_spec_matches_partition_spec_by_tuple():
    for parts in [(), (None,), ("data", None), (("data",), None), (("pod", "data"), "model"),
                  (None, ("data", "model"))]:
        assert tuple(P(*parts)) == tuple(JP(*parts))
    assert P(("data",)) == P("data") and hash(P("a", None)) == hash(P("a", None))
    assert np.array_equal(len(P(None, "model")), 2)


def _axis_sizes(cfg) -> dict:
    """The count of units along each logical axis that a "model" dim of a
    param carries (a dim holds a whole number of them)."""
    heads = cfg.d_model // cfg.rwkv_head_dim if "rwkv" in cfg.block_group else cfg.n_heads
    return {"vocab": cfg.padded_vocab, "heads": heads, "kv_heads": cfg.n_kv_heads,
            "ffn": math.gcd(cfg.d_ff, cfg.moe_d_ff * cfg.n_shared_experts),
            "lru_width": cfg.lru_width or cfg.d_model, "experts": cfg.n_experts}


@pytest.mark.parametrize("arch", list(ARCHS))
def test_model_axis_names_the_axis_of_every_model_dim(arch):
    """``model_axis`` gives every full-shape param whose spec names
    ``"model"`` a logical axis (and no other param one), and the dim that
    the spec puts on ``"model"`` holds a whole number of that axis's units
    (heads, kv heads, ffn, RG-LRU channels, vocabulary, experts)."""
    rc, pc = _configs(arch, False)
    params = _meta(ref_build(rc).init_shapes())
    specs = PPt.param_specs(params, pc, abstract_mesh(*MESHES["16x16"]))
    sizes, seen = _axis_sizes(pc), {}

    def check(path, spec):
        node = params
        for k in path:
            node = node[k]
        axis = PPt.model_axis(path, node)
        dims = [d for d, part in enumerate(spec) if part == "model"]
        assert (axis is None) == (not dims), (path, spec, axis)
        if dims:
            assert sizes[axis] and node.shape[dims[0]] % sizes[axis] == 0, (path, axis)
            seen[axis] = seen.get(axis, 0) + 1

    tree_map_with_path(check, specs)
    assert all(seen.get(a) for a in ("vocab", "heads", "ffn")), seen
