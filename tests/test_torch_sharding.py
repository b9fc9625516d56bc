"""The port's logical-axis rules (``repro_torch.parallel.sharding``) against
the reference's, on the CPU.

* ``make_rules`` maps every logical axis as the reference does, for every
  config on the production meshes (abstract: names and sizes only), with
  and without the sequence-parallel override and ``force_head_sharding``.
* ``axis_rules`` nests and restores, and is per thread.
* ``shard``: a no-op without rules, a ``ValueError`` on a rank mismatch,
  a plain tensor unchanged under rules, a DTensor redistributed to the
  spec's placements (a one-rank gloo mesh).
* ``shard_map_compat`` on 2 gloo ranks (subprocesses): each rank sees its
  own shard, and the outputs are DTensors of the out specs.
"""
import dataclasses
import threading

import pytest
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch_dist_helpers import dist_guard, one_rank, run_ranks  # noqa: F401

from repro.configs import ARCHS
from repro.parallel import sharding as RS

import repro_torch.configs as PC
from repro_torch.parallel import sharding as PS

LOGICAL = ("batch", "heads", "kv_heads", "ffn", "experts", "vocab", "seq_model", "fsdp", "other")
MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((4,), ("data",)), ((2, 8), ("pod", "model"))]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_rules_match_reference(arch):
    for force in (False, True):
        rc = dataclasses.replace(ARCHS[arch], force_head_sharding=force)
        pc = PC.ModelConfig(**dataclasses.asdict(rc))
        for sizes, names in MESHES:
            rmesh, pmesh = RS.abstract_mesh(sizes, names), PS.abstract_mesh(sizes, names)
            for over in (None, {"seq_model": "model"}, {"batch": "data"}):
                want = RS.make_rules(rmesh, rc, over)
                got = PS.make_rules(pmesh, pc, over)
                assert got.mapping == want.mapping
                assert [got.resolve(n) for n in LOGICAL] == [want.resolve(n) for n in LOGICAL]
                assert tuple(got.spec("batch", None, "heads")) == tuple(
                    want.spec("batch", None, "heads"))
    mesh = PS.abstract_mesh((16, 16), ("data", "model"))
    assert PS.make_rules(mesh).mapping == RS.make_rules(
        RS.abstract_mesh((16, 16), ("data", "model"))).mapping


def test_abstract_mesh_has_names_and_sizes():
    m = PS.abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert PS.mesh_axes(m) == {"pod": 2, "data": 16, "model": 16}


def test_axis_rules_nest_restore_and_stay_in_their_thread():
    mesh = PS.abstract_mesh((16, 16), ("data", "model"))
    a, b = PS.make_rules(mesh), PS.make_rules(mesh, overrides={"seq_model": "model"})
    seen = []
    assert PS.current_rules() is None
    with PS.axis_rules(a):
        with PS.axis_rules(b):
            assert PS.current_rules() is b
            t = threading.Thread(target=lambda: seen.append(PS.current_rules()))
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
        assert PS.current_rules() is a
        with pytest.raises(RuntimeError), PS.axis_rules(None):
            assert PS.current_rules() is None
            raise RuntimeError
        assert PS.current_rules() is a
    assert PS.current_rules() is None and seen == [None]


def test_shard_without_rules_and_on_plain_tensors():
    x = torch.ones(4, 3)
    assert PS.shard(x, "batch") is x  # no rules: no check either, as the reference
    with PS.axis_rules(PS.make_rules(PS.abstract_mesh((16, 16), ("data", "model")))):
        assert PS.shard(x, "batch", None) is x
        with pytest.raises(ValueError, match="2 names"):
            PS.shard(torch.ones(2), "batch", None)


def test_shard_redistributes_a_dtensor(one_rank):
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    x = torch.arange(12.0).reshape(4, 3)
    d = DTensor.from_local(x, mesh, (Replicate(), Replicate()))
    with PS.axis_rules(PS.make_rules(mesh)):
        got = PS.shard(d, "batch", "vocab")
    assert got.placements == (Shard(0), Shard(1))
    assert torch.equal(got.full_tensor(), x)
    assert PS.spec_placements(mesh, PS.P(("data", "model"))) == (Shard(0), Shard(0))


def test_shard_map_compat_on_two_gloo_ranks(tmp_path):
    run_ranks("""
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from repro_torch.parallel.sharding import P, place, shard_map_compat
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
        x = torch.arange(24.0).reshape(6, 4)
        y = torch.arange(4.0)

        def f(xl, yl):
            assert xl.shape == (3, 4) and yl.shape == (4,)
            s = xl.sum(0) + yl
            dist.all_reduce(s, group=mesh.get_group("data"))
            return xl * 2, s

        fn = shard_map_compat(f, mesh=mesh, in_specs=(P("data", None), P()),
                              out_specs=(P("data", None), P()))
        for arg in (x, place(x, mesh, (Replicate(),))):
            a, s = fn(arg, y)
            assert isinstance(a, DTensor) and a.placements == (Shard(0),)
            assert torch.equal(a.full_tensor(), x * 2)
            assert torch.equal(s.to_local(), x.sum(0) + 2 * y)
        # the manual axes only: "data" left out keeps the input whole
        fn = shard_map_compat(lambda xl: xl + 0, mesh=mesh, in_specs=(P("data", None),),
                              out_specs=P(None, None), axis_names=())
        assert torch.equal(fn(x).to_local(), x)
    """, 2, tmp_path)
