"""The port's sharded train and prefill steps (``make_train_step`` and
``make_prefill_step`` on a DeviceMesh: params, gradients and AdamW moments
as each rank's ``param_specs`` shards, FSDP gathers a block at a time, the
dense family's heads, ffn and vocab split over ``"model"``) on the CPU.

A reduced dense config (``TINY``: 2 layers, d_model 64, 4 heads of 16,
``qk_norm``, tied embeddings, vocab 512) in two cases: 1 kv head, which
the 2-way ``"model"`` axis does not divide (the rules replicate it: each
rank gathers ``wk``/``wv`` whole and reads the kv head of its query
heads), and 2 kv heads, which it splits.

* On 4 gloo ranks, a ("data", "model") mesh of 2 x 2, 3 sharded steps of
  the global batch of 8 x 32 and one prefill of the global batch (made
  whole), against the port's one-device step, within ``torch_tp_case``'s bounds
  (measured: first-step gradients at most 2.6% of a leaf's largest
  |gradient|, params 4.0%, movement 1.8%, loss 8.6e-5 relative, grad norm
  7.4e-4 at step 1 and 1.09e-3 after, logits 0.0059 apart).  Every rank
  ends with the same whole state.
* The same 3 steps and prefill with float32 compute on both sides: the
  gradients, losses and grad norms within 1e-5 relative (measured at most
  8.5e-7 for gradients, 2.5e-7 for grad norms), the witness that the
  bfloat16 run's gaps (grad norm up to 2e-3 at steps 2-3) are the rounding
  of bf16 products over split contractions and not a fault of the
  tensor-parallel step.
* The same on the reference's ``make_train_step``, jitted with in and out
  shardings from its ``param_specs`` and ``train_state_specs`` on a 2 x 2
  Auto-axis mesh of 4 host devices (a subprocess with its own
  ``XLA_FLAGS``), one step from the reference's params: the loss within
  0.01, the grad norm within rtol 0.02, each averaged gradient within 6%
  of the leaf's largest |gradient|, each param within 2.1 x the step's
  learning rate (AdamW's first update is about lr x sign(g), so a
  gradient element near zero may take either sign), the bounds with which
  ``tests/test_torch_train_step.py`` holds one device to the reference
  (measured: loss 3.3e-5 apart, grad norm 5.1e-4 relative, gradients
  4.3%, params 2.0 x lr where an element's update took the other sign).
* A one-rank (1, 1) mesh: 3 steps and the prefill bit-equal to one
  device's (the collectives run on groups of one).
* Checkpoints of a sharded state on 2 gloo ranks, a (1, 2) mesh: the
  ``TrainingRunner`` (rank 0 writes, rank 1 takes part in each save's
  gathers) crashes at step 3 and resumes from its step-2 checkpoint onto
  its shards, landing on the uninterrupted run's state and losses bit for
  bit; each checkpoint file equals a save of the same state made whole.
* The other families' cases are in
  ``tests/test_torch_tensor_parallel_families.py`` (a file of their own,
  so that a pytest run distributed by file runs the two side by side).
* The replicated leaves on their own, one step on a (1, 2) mesh (tensor
  parallelism only): ``q_norm`` and ``k_norm`` act on each rank's heads and
  their gradients sum over ``"model"``; ``wk``/``wv`` (1 kv head, gathered
  over ``"model"``) sum their ranks' slices; each within 6% of the
  one-device gradient's largest |value| (measured at most 1.7%); the
  block norms, replicated and computed the same on both ranks, equal on
  both ranks bit for bit.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch_dist_helpers import ROOT, RANK_TIMEOUT, dist_guard, one_rank, run_ranks  # noqa: F401
from torch_dist_helpers import whole
from torch_tp_case import GRAD_REL, OPT, cache_tensors, gaps, leaf_names, one_device, run
from torch_tp_case import run_workers, setup, within

from repro import configs as RC
from repro import models as RM

from repro_torch.training import AdamWConfig, make_prefill_step, make_train_step
from repro_torch.training._tree import leaves
from repro_torch.training.optimizer import _schedule

REF_LOSS_TOL, REF_GNORM_RTOL = 0.01, 0.02  # the port against the reference
F32_REL = 1e-5  # float32 compute: gradients, losses and grad norms


@pytest.mark.parametrize(("kv", "dtype"), [(1, "bfloat16"), (2, "bfloat16"), (1, "float32"),
                                         (2, "float32")], ids=["1", "2", "1-float32", "2-float32"])
def test_sharded_step_on_four_gloo_ranks_matches_one_device(kv, dtype, tmp_path):
    """In float32 compute the first step's gradients, every loss and every
    grad norm also stay within 1e-5 relative (measured at most 8.5e-7,
    7.8e-8 and 2.5e-7): the bfloat16 run's gaps are its rounding."""
    g = gaps(run_workers(tmp_path, kv, dtype), kv, dtype)
    assert within(g, dtype), {k: v for k, v in g.items() if k != "local_shapes"}
    if dtype == "float32":
        assert max([g["grad"], *g["loss_rel"], *g["gnorm_rel"]]) <= F32_REL, g


# the reference's train step jitted with its param_specs shardings on a 2 x
# 2 Auto-axis mesh of 4 host devices, in a process of its own (the device
# count is fixed when JAX starts); its gradient at the given params too
_REF_STEP = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec
from repro.configs.base import ModelConfig
from repro.models import build_model
from repro.parallel.partition import param_specs
from repro.parallel.sharding import axis_rules, make_rules
from repro.training.optimizer import AdamWConfig, adamw_init
from repro.training.train_step import make_train_step, train_state_specs
d, tiny, opt, keys = sys.argv[1], eval(sys.argv[2]), eval(sys.argv[3]), eval(sys.argv[4])
shape = eval(sys.argv[5])
model = build_model(ModelConfig(**tiny))
inp = np.load(f"{d}/ref_in.npz")
like = jax.eval_shape(model.init, jax.random.PRNGKey(0))
params = jax.tree.unflatten(jax.tree.structure(like), [jnp.asarray(inp[f"arr_{i}"])
                                                       for i in range(len(jax.tree.leaves(like)))])
mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2)

def named(specs):
    return jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                        is_leaf=lambda x: isinstance(x, PartitionSpec))

p_sh = named(param_specs(params, model.cfg, mesh))
o_sh = named(train_state_specs(params, model.cfg, mesh))
b_sh = NamedSharding(mesh, PartitionSpec("data"))
batch = {k: jnp.asarray(inp[k]) for k in keys}
rules = make_rules(mesh, model.cfg)

def loss(p, b):
    with axis_rules(rules):
        return model.loss(p, b)[0]

with mesh:
    grads = jax.jit(jax.grad(loss), in_shardings=(p_sh, b_sh), out_shardings=p_sh)(params, batch)
    step = jax.jit(make_train_step(model, mesh, AdamWConfig(**opt)),
                   in_shardings=(p_sh, o_sh, b_sh),
                   out_shardings=(p_sh, o_sh, NamedSharding(mesh, PartitionSpec())))
    new, _, metrics = step(params, adamw_init(params), batch)
np.savez(f"{d}/ref_out.npz", *[np.asarray(t) for t in jax.tree.leaves(new)],
         **{f"g{i}": np.asarray(g) for i, g in enumerate(jax.tree.leaves(grads))},
         loss=np.asarray(metrics["loss"]), gnorm=np.asarray(metrics["grad_norm"]),
         aux=np.asarray(metrics["moe_aux"]))
"""


def start_reference(case, tmp_path, mesh: tuple = (2, 2)) -> subprocess.Popen:
    """The reference's step of ``setup(case)``'s first global batch, jitted
    with its shardings on 4 host devices (a ("data", "model") mesh of
    ``mesh``), started in a subprocess that writes ``ref_out.npz``; the
    reference's params are saved as ``params.npz``, from which the port's
    ranks start."""
    model, _, batches = setup(case)
    config = dataclasses.asdict(model.cfg)
    rp = RM.build_model(RC.ModelConfig(**config)).init(jax.random.PRNGKey(0))
    batch = {k: v.numpy() for k, v in batches[0].items()}
    np.savez(tmp_path / "ref_in.npz", *[np.asarray(t) for t in jax.tree.leaves(rp)], **batch)
    np.savez(tmp_path / "params.npz", *[np.asarray(t) for t in jax.tree.leaves(rp)])
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    return subprocess.Popen([sys.executable, "-c", _REF_STEP, str(tmp_path), repr(config),
                             repr(OPT), repr(sorted(batch)), repr(mesh)],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish_reference(ref: subprocess.Popen, tmp_path):
    """The reference's arrays, once its subprocess has exited 0."""
    try:
        log = ref.communicate(timeout=RANK_TIMEOUT)[0]
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, log
    return np.load(tmp_path / "ref_out.npz")


def hold_to_reference(got, want) -> None:
    """The port's one step (a rank's saved arrays) against the reference's
    within the bounds above."""
    assert abs(float(got["loss"][0]) - float(want["loss"])) < REF_LOSS_TOL
    np.testing.assert_allclose(float(got["gnorm"][0]), float(want["gnorm"]), rtol=REF_GNORM_RTOL)
    lr = float(_schedule(AdamWConfig(**OPT), torch.tensor(1)))
    for i in range(sum(k.startswith("arr_") for k in want.files)):
        g, w = got[f"g{i}"], want[f"g{i}"]
        assert g.shape == w.shape and np.abs(g - w).max() <= GRAD_REL * np.abs(w).max(), i
        np.testing.assert_allclose(got[f"arr_{i}"], want[f"arr_{i}"], rtol=0, atol=2.1 * lr)


def _against_the_reference(case, tmp_path):
    """The port's step on 4 gloo ranks against the reference's jitted with
    its shardings on 4 host devices, from the reference's params, one step
    of the global batch (``setup(case)``'s first)."""
    ref = start_reference(case, tmp_path)
    got = run_workers(tmp_path, case, steps=1)[0]
    hold_to_reference(got, finish_reference(ref, tmp_path))


@pytest.mark.parametrize("kv", [1, 2])
def test_sharded_step_matches_the_references_sharded_step(kv, tmp_path):
    _against_the_reference(kv, tmp_path)


@pytest.mark.parametrize("kv", [1, 2])
def test_one_rank_mesh_is_bit_equal_to_one_device(kv, one_rank):
    model, params, batches = setup(kv)
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    opt = AdamWConfig(**OPT)
    got = run(make_train_step(model, mesh, opt), params, batches)
    want = run(make_train_step(model, None, opt), params, batches)
    assert all(torch.equal(a, b) for a, b in zip(whole(got[:2]), leaves(want[:2]), strict=True))
    for g, w in zip(got[2], want[2]):
        assert list(g) == list(w) and all(torch.equal(g[k], w[k]) for k in w)
    with torch.no_grad():
        a = make_prefill_step(model, mesh)(params, {"tokens": batches[0]["tokens"]})
        b = make_prefill_step(model, None)(params, {"tokens": batches[0]["tokens"]})
    assert all(torch.equal(x, y) for x, y in zip([a[0].to_local()] + cache_tensors(a[1]),
                                                 [b[0]] + cache_tensors(b[1]), strict=True))


# one sharded step on a (1, 2) mesh: saves each rank's local gradient of
# every leaf of the first block (the ranks' own pieces) with the specs'
# placements, made whole
_REPLICATED_WORKER = """
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.training import AdamWConfig, adamw_init, make_train_step
    from repro_torch.training import train_step as TS
    from repro_torch.training._tree import leaves
    from torch_dist_helpers import recording_update, whole_grads
    from torch_tp_case import OPT, setup
    model, params, batches = setup(1)
    seen = []
    TS._update = recording_update(seen)
    mesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
    make_train_step(model, mesh, AdamWConfig(**OPT))(params, adamw_init(params), batches[0])
    grads = whole_grads(model, params, mesh, seen[0])
    np.savez(f"{d}/out{rank}.npz", *[g.numpy() for g in grads],
             *[g.numpy() for g in seen[0]])
"""


def test_replicated_leaf_gradients_sum_over_model(tmp_path):
    """q_norm and k_norm act on each rank's heads, wk and wv (one kv head,
    gathered whole) on its kv head: their gradients are the ranks' sum;
    the block norms get the same gradient on both ranks."""
    run_ranks(_REPLICATED_WORKER, 2, tmp_path)
    model, params, batches = setup(1)
    _, _, _, want = one_device(model, params, batches[:1])
    outs = [np.load(tmp_path / f"out{r}.npz") for r in range(2)]
    n = len(want)
    names = leaf_names(params)
    for name in ("groups.pos0.attn.q_norm", "groups.pos0.attn.k_norm", "groups.pos0.attn.wk",
                 "groups.pos0.attn.wv"):
        i = names.index(name)
        err = np.abs(outs[0][f"arr_{i}"] - want[i]).max()
        assert err <= GRAD_REL * np.abs(want[i]).max(), (name, err)
    for name in ("groups.pos0.ln1", "groups.pos0.ln2", "ln_f"):
        i = names.index(name)  # replicated: each rank's own gradient, equal on both
        np.testing.assert_array_equal(outs[0][f"arr_{n + i}"], outs[1][f"arr_{n + i}"])
        assert np.abs(outs[0][f"arr_{n + i}"] - want[i]).max() <= GRAD_REL * np.abs(want[i]).max()


# the runner on a (1, 2) mesh: 5 steps into a/ uninterrupted; into b/ a crash
# at step 3, then a resume; rank 0 writes, both ranks gather each save
_RUNNER_WORKER = """
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.parallel import param_shardings
    from repro_torch.parallel.sharding import place
    from repro_torch.training import AdamWConfig, TrainingRunner, adamw_init, make_train_step
    from repro_torch.training import save_checkpoint
    from repro_torch.training._tree import tree_map, unflatten
    from torch_dist_helpers import whole
    from torch_tp_case import OPT, setup
    model, params, batches = setup(2)
    mesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
    placed = tree_map(lambda p, s: place(p, *s), params, param_shardings(params, model.cfg, mesh))
    step = make_train_step(model, mesh, AdamWConfig(**OPT))

    def runner_step(state, batch):
        p, o, m = step(state["params"], state["opt"], batch)
        return {"params": p, "opt": o}, m

    def runner(directory, fail_at=None):
        return TrainingRunner(runner_step, lambda s: batches[s % len(batches)],
                              {"params": placed, "opt": adamw_init(placed)},
                              ckpt_dir=f"{d}/{directory}", ckpt_every=2, codec="none",
                              writes=rank == 0, fail_at=fail_at)

    a = runner("a")
    hist = a.run(5)
    try:
        runner("b", fail_at=3).run(5)
        raise AssertionError("no crash")
    except RuntimeError:
        pass
    dist.barrier()  # rank 0's step-2 checkpoint is on disk
    b = runner("b")
    assert b.start_step == 3
    resumed = b.run(5)
    assert [h["loss"] for h in resumed] == [h["loss"] for h in hist[3:]]
    state = whole(a.state)
    assert all(torch.equal(x, y) for x, y in zip(state, whole(b.state), strict=True))
    if rank == 0:  # the same state made whole, saved as one device saves it
        like = {"params": params, "opt": adamw_init(params)}
        save_checkpoint(f"{d}/plain", 4, unflatten(like, state), codec="none")
    dist.barrier()
"""


def test_sharded_runner_checkpoints_and_resumes_on_two_gloo_ranks(tmp_path):
    run_ranks(_RUNNER_WORKER, 2, tmp_path)
    files = sorted((tmp_path / "a" / "step_4").glob("leaf_*.bin"))
    assert files and (tmp_path / "a" / "LATEST").read_text() == "4"
    for f in files:
        assert f.read_bytes() == (tmp_path / "plain" / "step_4" / f.name).read_bytes()
