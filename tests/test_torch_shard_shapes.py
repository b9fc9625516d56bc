"""Each rank's shard of every param leaf in the port's sharded steps, against
JAX's ``NamedSharding(mesh, spec).shard_shape(shape)`` for the reference's
``param_specs``, on the CPU: all ten configs at their full shapes (meta
tensors and ``jax.eval_shape``: nothing allocated) on the production
meshes, 16x16 ("data", "model") and 2x16x16 ("pod", "data", "model"), each
config on the second also with ``dcn_fsdp`` (the fsdp axis ("pod",
"data"), llama4's own setting).  The meshes are abstract on JAX's side
(``AbstractMesh``: names and sizes, no 256 devices).

* ``parallel.partition.shard_shape`` of the port's spec equals JAX's for
  every leaf.
* The shards a step holds: ``parallel.collectives.Shards.local``, the
  train and prefill steps' placement, run on rank 0 of a fake world of 256
  or 512 ranks (torch's ``fake`` process group, in a subprocess) on the
  production mesh, gives those shapes (every rank's shard has one shape:
  the axes divide every dim they split).
* A dim that its axes do not divide: JAX refuses it with ``ValueError``,
  and so do the port's ``shard_shape`` and a sharded step's placement (a
  d_model of 24 over 16 data ranks).
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP
from torch_dist_helpers import ROOT, dist_guard  # noqa: F401

from repro.configs import ARCHS
from repro.models import build_model as ref_build
from repro.parallel import partition as RPt

import repro_torch.configs as PC
from repro_torch.parallel import partition as PPt
from repro_torch.parallel.sharding import P, abstract_mesh, tree_map_with_path

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
CASES = [(arch, mesh, dcn) for arch in sorted(ARCHS) for mesh in MESHES
         for dcn in ((False, True) if mesh == "2x16x16" else (False,))]
TIMEOUT = 300

# rank 0 of a fake world on the production mesh: each case's local shard
# shapes as a sharded step places them, by leaf path
_FAKE_WORLD = """
import dataclasses, json, sys
import torch
from repro_torch.configs import ARCHS
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.parallel.collectives import Shards
from repro_torch.parallel.sharding import tree_map_with_path
multi, out = sys.argv[1] == "2x16x16", {}
with fake_world(512 if multi else 256):
    mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
    for arch in sorted(ARCHS):
        for dcn in ((False, True) if multi else (False,)):
            cfg = ARCHS[arch]
            cfg = dataclasses.replace(cfg, dcn_fsdp=cfg.dcn_fsdp or dcn)
            params = build_model(cfg).init_shapes()
            sh = Shards(mesh, cfg)
            shapes = {}
            tree_map_with_path(lambda p, t: shapes.__setitem__(".".join(map(str, p)),
                                                               list(t.shape)),
                               sh.local(params, sh.specs(params)))
            out[f"{arch} {dcn}"] = shapes
    odd = dataclasses.replace(ARCHS["qwen3-0.6b"], d_model=24)
    params = build_model(odd).init_shapes()
    sh = Shards(mesh, odd)
    try:
        sh.local(params, sh.specs(params))
        out["refused"] = None
    except ValueError as e:
        out["refused"] = type(e).__name__
print("SHAPES " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def step_shapes():
    """Each mesh's fake-world run, both started at once: {mesh: {case: {path:
    shape}}}."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {m: subprocess.Popen([sys.executable, "-c", _FAKE_WORLD, m], env=env,
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for m in MESHES}
    out = {}
    try:
        for m, p in procs.items():
            log = p.communicate(timeout=TIMEOUT)[0]
            assert p.returncode == 0, log
            (line,) = [ln for ln in log.splitlines() if ln.startswith("SHAPES ")]
            out[m] = json.loads(line[len("SHAPES "):])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def _key(entry):
    for attr in ("key", "idx", "name"):
        if hasattr(entry, attr):
            return getattr(entry, attr)
    raise TypeError(entry)


def _meta(tree):
    """The reference's shape tree as the port's tree of meta tensors."""
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_meta(v) for v in tree)
    return torch.empty(tuple(tree.shape), device="meta")


def _jax_shard_shapes(shapes, specs, mesh) -> dict:
    """{leaf path: JAX's shard shape} for the reference's shape and spec
    trees."""
    flat_specs = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, JP))[0]
    flat_shapes = jax.tree_util.tree_flatten_with_path(shapes)[0]
    assert [p for p, _ in flat_specs] == [p for p, _ in flat_shapes]
    return {".".join(str(_key(e)) for e in path): list(NamedSharding(mesh, spec).shard_shape(
        leaf.shape)) for (path, spec), (_, leaf) in zip(flat_specs, flat_shapes)}


@pytest.mark.parametrize("arch,mesh,dcn", CASES)
def test_shard_shapes_equal_jax(arch, mesh, dcn, step_shapes):
    rc = ARCHS[arch]
    rc = dataclasses.replace(rc, dcn_fsdp=rc.dcn_fsdp or dcn)
    pc = PC.ModelConfig(**dataclasses.asdict(rc))
    sizes, names = MESHES[mesh]
    jmesh, pmesh = AbstractMesh(sizes, names), abstract_mesh(sizes, names)
    shapes = ref_build(rc).init_shapes()
    want = _jax_shard_shapes(shapes, RPt.param_specs(shapes, rc, jmesh), jmesh)
    params = _meta(shapes)
    specs = PPt.param_specs(params, pc, pmesh)
    got = {}

    def visit(path, leaf):
        got[".".join(map(str, path))] = list(PPt.shard_shape(leaf.shape, _spec_at(specs, path),
                                                             pmesh))

    tree_map_with_path(visit, params)
    assert got == want
    assert step_shapes[mesh][f"{arch} {dcn}"] == want
    # something is split: no config keeps every leaf whole
    assert any(w != list(leaf.shape) for w, leaf in zip(want.values(),
                                                        jax.tree.leaves(shapes)))


def _spec_at(tree, path):
    for k in path:
        tree = tree[k]
    assert isinstance(tree, P)
    return tree


def test_a_dim_its_axes_do_not_divide_is_refused(step_shapes):
    """JAX's shard_shape and the port's raise ValueError for a dim of 3
    over 2 ranks and split a dim of 4; a sharded step's placement refuses
    a config whose d_model (24) the 16 data ranks do not divide."""
    jmesh, pmesh = AbstractMesh((2, 2), ("data", "model")), abstract_mesh((2, 2),
                                                                          ("data", "model"))
    assert NamedSharding(jmesh, JP("data", "model")).shard_shape((4, 6)) == (2, 3)
    assert PPt.shard_shape((4, 6), P("data", "model"), pmesh) == (2, 3)
    with pytest.raises(ValueError):
        NamedSharding(jmesh, JP("data", None)).shard_shape((3, 6))
    with pytest.raises(ValueError, match="does not divide"):
        PPt.shard_shape((3, 6), P("data", None), pmesh)
    assert step_shapes["16x16"]["refused"] == "ValueError"
