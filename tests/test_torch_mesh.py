"""The port's meshes (``repro_torch.launch.mesh``), its data-parallel train
step (``repro_torch.training.train_step.make_train_step`` over a mesh) and
checkpoints restored onto a mesh (``load_checkpoint(shardings=)`` with
``param_shardings``), on the CPU.

* ``make_production_mesh`` in a world of one raises ``ConfigError``
  naming the world it needs (256, or 512 multi-pod), as the reference's
  ``jax.make_mesh`` fails on one device; no process group is made.
  ``make_local_mesh`` on a one-rank gloo group.  ``HW`` holds the H100's
  published figures.
* The sharded step on one-rank meshes ((1, 1) and (1, 1, 1), which takes
  the pod x data plane's own group) equals the one-device step bit for bit
  over 3 steps: params, optimizer state and metrics; its params and
  moments come back as DTensors of their specs' placements.
* On 2 gloo ranks ((2, 1) "data", "model") and on 4 ((2, 2, 1) "pod",
  "data", "model"), in subprocesses, against the one-device step on the
  whole global batch of 8 x 32, 2 steps: every rank ends with the same
  bits; the first step's gradient averaged over the ranks (what AdamW is
  given, before the clip) within 2^-7, the bf16 epsilon, of the leaf's
  largest |gradient| (measured at most 0.0043: the model computes in
  bf16, and a rank's matmuls over its 2 or 4 rows round otherwise than
  over all 8); after 2 steps each param leaf's mean |difference| within
  5% of its mean movement from the start (measured at most 1.8%: AdamW
  moves an element by about lr x sign(m / sqrt(v)), so an element whose
  gradient is near zero may move the other way; a step whose update were
  lost would differ by 100%); the first step's loss (the same params)
  within 1e-5, the second's within 1e-3, each grad norm within rtol 2e-3.
* The same step on 2 gloo ranks against the reference's GSPMD
  ``make_train_step`` on a ("data", "model") mesh of 2 host devices (a
  subprocess with its own ``XLA_FLAGS``), one step from the reference's
  params: the loss within 0.01, the grad norm within rtol 0.02, each
  averaged gradient within 6% of the leaf's largest |gradient| (measured
  at most 1.8%), the bounds with which ``tests/test_torch_train_step.py``
  holds the one-device step to the reference, and each param leaf's mean
  |difference| within 5% of its mean movement (measured at most 1.1%).
* A mesh checkpoint: a state saved from plain tensors is restored onto a
  (1, 1, 1) mesh through ``param_shardings`` (each leaf a DTensor with
  its spec's placements, equal to the saved leaf), saved again from the
  DTensors (the same bytes), and restored on 2 gloo ranks onto a (1, 1, 2)
  mesh, a new one (an elastic restart): each rank holds ``torch.chunk``'s
  piece of every leaf split over "model".  Training resumes from the
  restored DTensors: a sharded step from them on the (1, 1, 1) mesh
  in-process equals the one-device step from the saved plain state bit for
  bit; on the (1, 1, 2) mesh, where it splits heads, ffn and vocab over
  the 2 ranks, within the bounds of ``_resumed_step_equals_the_plain_step``;
  both return DTensors of the specs' placements.

The multi-rank steps return each rank's shards: the workers gather them
(``full_tensor``) before saving, and the recorded gradient (each rank's
shards) is made whole on its params' placements.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from torch_dist_helpers import ROOT, RANK_TIMEOUT, dist_guard, one_rank, run_ranks  # noqa: F401
from torch_dist_helpers import placed_as_specs as _placed_as_specs
from torch_dist_helpers import recording_update as _recording_update
from torch_dist_helpers import whole as _whole

from repro import configs as RC
from repro import models as RM

import repro_torch.configs as PC
from repro_torch.core.errors import ConfigError
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import mesh as M
from repro_torch.models import build_model
from repro_torch.parallel import param_shardings, param_specs
from repro_torch.parallel.sharding import spec_placements
from repro_torch.training import AdamWConfig, adamw_init, load_checkpoint, make_train_step
from repro_torch.training import save_checkpoint
from repro_torch.training import train_step as TS
from repro_torch.training._tree import leaves

TINY = dict(name="lm-tiny", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            d_ff=256, vocab_size=512, head_dim=16, tie_embeddings=True)  # tests/test_system.py
OPT = dict(lr=1e-3, warmup_steps=2, decay_steps=10)
BF16_EPS = 2.0**-7  # the gap between 1 and the next bf16
LOSS_TOL, GRAD_REL = 0.01, 0.06  # the port against the reference (tests/test_torch_train_step.py)


def _setup(seed=0):
    model = build_model(PC.ModelConfig(**TINY))
    params = model.init(seed, device="cpu")
    pipe = TokenPipeline(vocab_size=TINY["vocab_size"], batch=8, seq_len=32, seed=5)
    batches = [{k: torch.from_numpy(v) for k, v in pipe.batch_at(s).items()} for s in range(3)]
    return model, params, batches


def _run(step, params, batches):
    opt, out = adamw_init(params), []
    for b in batches:
        params, opt, metrics = step(params, opt, b)
        out.append(metrics)
    return params, opt, out


def test_production_mesh_names_the_world_it_needs():
    with pytest.raises(ConfigError, match="needs a world of 256 ranks"):
        M.make_production_mesh()
    with pytest.raises(ConfigError, match="needs a world of 512 ranks.*has 1"):
        M.make_production_mesh(multi_pod=True)


def test_local_mesh_and_hw(one_rank):
    mesh = M.make_local_mesh(1, 1, device_type="cpu")
    assert mesh.mesh_dim_names == ("data", "model") and mesh.shape == (1, 1)
    assert (M.HW.PEAK_BF16_FLOPS, M.HW.HBM_BW, M.HW.HBM_BYTES) == (989e12, 3.35e12, 80 * 2**30)


@pytest.mark.parametrize("shape,names", [((1, 1), ("data", "model")),
                                         ((1, 1, 1), ("pod", "data", "model"))])
def test_one_rank_mesh_step_is_the_one_device_step(shape, names, one_rank):
    model, params, batches = _setup()
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
    want = _run(make_train_step(model, None, AdamWConfig(**OPT)), params, batches)
    got = _run(make_train_step(model, mesh, AdamWConfig(**OPT)), params, batches)
    assert _placed_as_specs(model, params, mesh, got[0])
    assert all(_placed_as_specs(model, params, mesh, got[1][k]) for k in ("m", "v"))
    assert all(torch.equal(a, b) for a, b in zip(_whole(got[:2]), leaves(want[:2]), strict=True))
    for g, w in zip(got[2], want[2]):
        assert list(g) == list(w) and all(torch.equal(g[k], w[k]) for k in w)


# the worker of the multi-rank step tests: params from params.npz where
# given (else _setup's), ``steps`` data-parallel steps on ``mesh``; saves
# every leaf of the state, the first step's averaged gradient and the metrics
_DP_WORKER = """
    import os
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.training import AdamWConfig, make_train_step, train_step as TS
    from repro_torch.training._tree import leaves, unflatten
    from test_torch_mesh import OPT, _run, _setup
    from torch_dist_helpers import recording_update as _recording_update
    from torch_dist_helpers import whole as _whole, whole_grads as _whole_grads
    model, params, batches = _setup()
    if os.path.exists(f"{{d}}/params.npz"):
        given = np.load(f"{{d}}/params.npz")
        params = unflatten(params, [torch.from_numpy(given[f"arr_{{i}}"])
                                    for i in range(len(given.files))])
    seen = []
    TS._update = _recording_update(seen)
    mesh = init_device_mesh("cpu", {shape!r}, mesh_dim_names={names!r})
    p, opt, metrics = _run(make_train_step(model, mesh, AdamWConfig(**OPT)), params,
                           batches[:{steps}])
    grads = _whole_grads(model, params, mesh, seen[0])
    np.savez(f"{{d}}/out{{rank}}.npz", *[t.numpy() for t in _whole((p, opt))],
             **{{f"g{{i}}": g.numpy() for i, g in enumerate(grads)}},
             loss=np.array([float(m["loss"]) for m in metrics]),
             gnorm=np.array([float(m["grad_norm"]) for m in metrics]))
"""


@pytest.mark.parametrize("shape,names", [((2, 1), ("data", "model")),
                                         ((2, 2, 1), ("pod", "data", "model"))])
def test_data_parallel_on_gloo_ranks_matches_the_whole_batch(shape, names, tmp_path,
                                                             monkeypatch):
    world = int(np.prod(shape))
    run_ranks(_DP_WORKER.format(shape=shape, names=names, steps=2), world, tmp_path)
    model, params, batches = _setup()
    seen = []
    monkeypatch.setattr(TS, "_update", _recording_update(seen))
    p, opt, metrics = _run(make_train_step(model, None, AdamWConfig(**OPT)), params, batches[:2])
    outs = [np.load(tmp_path / f"out{r}.npz") for r in range(world)]
    want = [t.numpy() for t in leaves((p, opt))]
    for out in outs:
        for i, w in enumerate(want):
            np.testing.assert_array_equal(out[f"arr_{i}"], outs[0][f"arr_{i}"])
        loss, gnorm = ([float(m[k]) for m in metrics] for k in ("loss", "grad_norm"))
        assert np.all(np.abs(out["loss"] - loss) <= [1e-5, 1e-3]), (out["loss"], loss)
        np.testing.assert_allclose(out["gnorm"], gnorm, rtol=2e-3)
    for i, g in enumerate(seen[0]):  # the first step's mean gradient, before AdamW
        g = g.numpy()
        err = np.abs(outs[0][f"g{i}"] - g).max()
        assert err <= BF16_EPS * np.abs(g).max(), (i, err, np.abs(g).max())
    for i, (p0, w) in enumerate(zip(leaves(params), want)):  # the update applied
        moved = np.abs(w - p0.numpy()).mean()
        assert moved > 0 and np.abs(outs[0][f"arr_{i}"] - w).mean() <= 0.05 * moved, i


# the reference's GSPMD train step (``repro.training.train_step``) on a
# ("data", "model") mesh of 2 host devices, in a process of its own (the
# device count is fixed when JAX starts); ``jax.make_mesh``'s default
# Explicit axes refuse the rules' sharding constraints, so Auto axes
_REF_MESH_STEP = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec
from repro.configs.base import ModelConfig
from repro.models import build_model
from repro.parallel.sharding import axis_rules, make_rules
from repro.training.optimizer import AdamWConfig, adamw_init
from repro.training.train_step import make_train_step
d, tiny, opt = sys.argv[1], eval(sys.argv[2]), eval(sys.argv[3])
model = build_model(ModelConfig(**tiny))
inp = np.load(f"{d}/ref_in.npz")
like = jax.eval_shape(model.init, jax.random.PRNGKey(0))
params = jax.tree.unflatten(jax.tree.structure(like), [jnp.asarray(inp[f"arr_{i}"])
                                                       for i in range(len(jax.tree.leaves(like)))])
mesh = jax.make_mesh((2, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
batch = jax.device_put({k: jnp.asarray(inp[k]) for k in ("tokens", "labels")},
                       NamedSharding(mesh, PartitionSpec("data")))
rules = make_rules(mesh, model.cfg)

def loss(p, b):
    with axis_rules(rules):
        return model.loss(p, b)[0]

with mesh:
    grads = jax.jit(jax.grad(loss))(params, batch)
    new, _, metrics = jax.jit(make_train_step(model, mesh, AdamWConfig(**opt)))(
        params, adamw_init(params), batch)
np.savez(f"{d}/ref_out.npz", *[np.asarray(t) for t in jax.tree.leaves(new)],
         **{f"g{i}": np.asarray(g) for i, g in enumerate(jax.tree.leaves(grads))},
         loss=np.asarray(metrics["loss"]), gnorm=np.asarray(metrics["grad_norm"]))
"""


def test_data_parallel_on_gloo_ranks_matches_the_references_mesh_step(tmp_path):
    """The port's step on 2 gloo ranks against the reference's on 2 host
    devices, from the reference's params, one step of the global batch."""
    ref_model = RM.build_model(RC.ModelConfig(**TINY))
    rp = ref_model.init(jax.random.PRNGKey(0))
    _, _, batches = _setup()
    batch = {k: v.numpy() for k, v in batches[0].items()}
    np.savez(tmp_path / "ref_in.npz", *[np.asarray(t) for t in jax.tree.leaves(rp)], **batch)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    ref = subprocess.run([sys.executable, "-c", _REF_MESH_STEP, str(tmp_path), repr(TINY),
                          repr(OPT)], env=env, capture_output=True, text=True,
                         timeout=RANK_TIMEOUT)
    assert ref.returncode == 0, ref.stdout + ref.stderr
    np.savez(tmp_path / "params.npz", *[np.asarray(t) for t in jax.tree.leaves(rp)])
    run_ranks(_DP_WORKER.format(shape=(2, 1), names=("data", "model"), steps=1), 2, tmp_path)
    got, want = np.load(tmp_path / "out0.npz"), np.load(tmp_path / "ref_out.npz")
    n = len(jax.tree.leaves(rp))
    assert abs(float(got["loss"][0]) - float(want["loss"])) < LOSS_TOL
    np.testing.assert_allclose(float(got["gnorm"][0]), float(want["gnorm"]), rtol=0.02)
    for i in range(n):
        g, w = got[f"g{i}"], want[f"g{i}"]
        err = np.abs(g - w).max()
        assert g.shape == w.shape and err <= GRAD_REL * np.abs(w).max(), (i, err)
    for i, p0 in enumerate(jax.tree.leaves(rp)):
        w, p0 = want[f"arr_{i}"], np.asarray(p0)
        moved = np.abs(w - p0).mean()
        assert moved > 0 and np.abs(got[f"arr_{i}"] - w).mean() <= 0.05 * moved, i


def _state():
    model, params, _ = _setup()
    return model, {"params": params, "opt": adamw_init(params)}


def _shardings(model, state, mesh):
    ps = param_shardings(state["params"], model.cfg, mesh)
    return {"params": ps, "opt": {"m": ps, "v": ps, "step": None}}


def test_mesh_checkpoint_round_trip(tmp_path, one_rank):
    model, state = _state()
    save_checkpoint(tmp_path / "a", 3, state, codec="none")
    mesh = init_device_mesh("cpu", (1, 1, 1), mesh_dim_names=("pod", "data", "model"))
    got, step = load_checkpoint(tmp_path / "a", state, shardings=_shardings(model, state, mesh))
    assert step == 3
    specs = param_specs(state["params"], model.cfg, mesh)
    for g, s, w in zip(leaves(got["params"]), leaves(specs), leaves(state["params"])):
        assert isinstance(g, DTensor) and g.placements == spec_placements(mesh, s)
        assert torch.equal(g.full_tensor(), w)
    assert not isinstance(got["opt"]["step"], DTensor)
    assert all(torch.equal(a.full_tensor() if isinstance(a, DTensor) else a, b)
               for a, b in zip(leaves(got), leaves(state)))
    # saved from DTensors: the same bytes; None restores onto the like leaf's mesh
    save_checkpoint(tmp_path / "b", 3, got, codec="none")
    for f in sorted((tmp_path / "a" / "step_3").glob("leaf_*.bin")):
        assert f.read_bytes() == (tmp_path / "b" / "step_3" / f.name).read_bytes()
    again, _ = load_checkpoint(tmp_path / "b", got)
    assert all(type(a) is type(b) and (not isinstance(a, DTensor) or a.placements == b.placements)
               for a, b in zip(leaves(again), leaves(got)))


def _resumed_step_equals_the_plain_step(model, state, restored, mesh, batch):
    """One sharded step on ``mesh`` from the mesh-restored state and one
    one-device step from the plain state, the params and moments DTensors of
    their specs' placements.  A mesh of one rank: the same bits.  Over a
    "model" axis of more than one (heads, ffn and vocab split): the loss
    within 1e-3 relative, each param leaf's mean |difference| within 5% of
    its mean movement (AdamW's first update is about lr x sign(g))."""
    opt = AdamWConfig(**OPT)
    got = make_train_step(model, mesh, opt)(restored["params"], restored["opt"], batch)
    want = make_train_step(model, None, opt)(state["params"], state["opt"], batch)
    assert _placed_as_specs(model, state["params"], mesh, got[0])
    assert all(_placed_as_specs(model, state["params"], mesh, got[1][k]) for k in ("m", "v"))
    if mesh.size() == 1:
        assert all(torch.equal(a, b) for a, b in zip(_whole(got), leaves(want), strict=True))
        return
    assert abs(float(got[2]["loss"]) - float(want[2]["loss"])) <= 1e-3 * float(want[2]["loss"])
    for a, b, p0 in zip(_whole(got[0]), leaves(want[0]), leaves(state["params"]), strict=True):
        moved = (b - p0).abs().mean()
        assert moved > 0 and (a - b).abs().mean() <= 0.05 * moved


def test_training_resumes_from_a_mesh_restored_state(tmp_path, one_rank):
    model, state = _state()
    save_checkpoint(tmp_path / "ck", 3, state, codec="none")
    mesh = init_device_mesh("cpu", (1, 1, 1), mesh_dim_names=("pod", "data", "model"))
    got, _ = load_checkpoint(tmp_path / "ck", state, shardings=_shardings(model, state, mesh))
    assert all(isinstance(t, DTensor) for t in leaves(got["params"]))
    _resumed_step_equals_the_plain_step(model, state, got, mesh, _setup()[2][0])


def test_elastic_restore_on_two_gloo_ranks(tmp_path):
    model, state = _state()
    save_checkpoint(tmp_path / "ck", 5, state, codec="none")
    run_ranks(f"""
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor, Shard
        from repro_torch.training import load_checkpoint
        from repro_torch.training._tree import leaves
        from test_torch_mesh import _resumed_step_equals_the_plain_step, _setup, _shardings
        from test_torch_mesh import _state
        model, state = _state()
        mesh = init_device_mesh("cpu", (1, 1, world), mesh_dim_names=("pod", "data", "model"))
        got, step = load_checkpoint({str(tmp_path / "ck")!r}, state,
                                    shardings=_shardings(model, state, mesh))
        assert step == 5
        split = 0
        for g, w in zip(leaves(got["params"]), leaves(state["params"])):
            pl = g.placements[2]
            want = w.chunk(world, dim=pl.dim)[rank] if isinstance(pl, Shard) else w
            split += isinstance(pl, Shard)
            assert torch.equal(g.to_local(), want)
            assert torch.equal(g.full_tensor(), w)
        assert split > 0
        _resumed_step_equals_the_plain_step(model, state, got, mesh, _setup()[2][0])
    """, 2, tmp_path)
