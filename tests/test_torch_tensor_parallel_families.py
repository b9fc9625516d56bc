"""Every other family's tensor parallelism on the sharded train and
prefill steps (``make_train_step`` and ``make_prefill_step`` on a
DeviceMesh), on the CPU: deepseek-v2-lite-16b's MLA and shared expert,
recurrentgemma-9b's RG-LRU and local attention, rwkv6-1.6b, the VLM's
cross-attention and seamless-m4t-medium's encoder split heads, width,
ffn and vocab over ``"model"`` as the reference's ``param_specs`` split
them.  The reduced configs and their batches are
``tests/torch_tp_case.py``'s ``FAMILY_CASES`` (the MoE routes every
expert, ``top_k`` 4 of 4: its near-uniform router at random init flips
the k-th expert under the rounding of split contractions, which moves a
token's output by a whole expert; the dense dispatch; the expert-parallel
cases are ``tests/test_torch_moe_ep.py``'s).  The dense cases and the
bounds' origin are in ``tests/test_torch_tensor_parallel.py``.

* (i) A one-rank (1, 1) mesh: 3 train steps and a prefill bit-equal to
  one device for every family (and a vocabulary of 510, which 1 divides).
* (ii) 4 gloo ranks on a 2 x 2 mesh: 3 sharded steps and a prefill of the
  global batch against one device, in bfloat16 within
  ``torch_tp_case.FAMILY_BF16`` and in float32 within the dense bounds,
  plus the float32 witness within 1e-5.
* (iii) The same against the reference's jitted step with its
  ``param_specs`` shardings on a 2 x 2 Auto-axis mesh of 4 host devices,
  within the dense case's bounds (loss 0.01, grad norm rtol 0.02,
  gradients 6% of a leaf's largest |value|, params 2.1 x lr).  The
  reference ran for every family.
* (v) A vocabulary of 510 on a (1, 4) mesh (the axis does not divide it):
  the train and prefill steps refuse it, as JAX's shardings refuse the
  reference's ``param_specs`` there.  Every configured model pads its
  vocabulary to a multiple of 128.
* ``cross_prefill_cache`` runs on one device only (the sharded steps
  make the cross caches in the block's prefill) and raises under a
  sharded step's rules.
"""
import pytest
import torch
from torch.distributed.device_mesh import init_device_mesh
from test_torch_tensor_parallel import F32_REL, _against_the_reference
from torch_dist_helpers import dist_guard, one_rank, whole  # noqa: F401
from torch_tp_case import (EP_CASES, FAMILY_CASES, HEADS_CASES, OPT, cache_tensors, gaps,
                           leaf_names, prompt_of, run, run_workers, setup, within)

from repro_torch.core.errors import ConfigError
from repro_torch.launch.dryrun import fake_world
from repro_torch.models import transformer as T
from repro_torch.parallel import param_specs
from repro_torch.parallel.collectives import Shards, step_specs
from repro_torch.parallel.partition import shard_shape
from repro_torch.parallel.sharding import abstract_mesh, axis_rules
from repro_torch.training import AdamWConfig, adamw_init, make_prefill_step, make_train_step
from repro_torch.training import train_step as TS
from repro_torch.training._tree import leaves

# the expert-parallel cases run in tests/test_torch_moe_ep.py, the uneven
# head splits in tests/test_torch_uneven_heads.py
FAMILIES = [c for c in FAMILY_CASES if c not in ("uneven", *EP_CASES, *HEADS_CASES)]


def _local_shapes_are_the_specs(g: dict, model, params, mesh: tuple) -> None:
    """Each rank's local shard of every leaf has the shape of the step's
    spec (a leaf that ``param_specs`` puts on ``"model"`` held split)."""
    am = abstract_mesh(mesh, ("data", "model"))
    specs = leaves(step_specs(params, model.cfg, am))
    want = {n: list(shard_shape(p.shape, s, am))
            for n, p, s in zip(leaf_names(params), leaves(params), specs)}
    assert all(shapes == want for shapes in g["local_shapes"].values())


@pytest.mark.parametrize("case", [*FAMILIES, "uneven"])
def test_families_one_rank_mesh_is_bit_equal_to_one_device(case, one_rank):
    """3 train steps and a prefill of each family on a (1, 1) mesh: every
    state leaf, metric, logit and cache bit-equal to one device."""
    model, params, batches = setup(case)
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    opt = AdamWConfig(**OPT)
    got = run(make_train_step(model, mesh, opt), params, batches)
    want = run(make_train_step(model, None, opt), params, batches)
    assert all(torch.equal(a, b) for a, b in zip(whole(got[:2]), leaves(want[:2]), strict=True))
    for g, w in zip(got[2], want[2]):
        assert list(g) == list(w) and all(torch.equal(g[k], w[k]) for k in w)
    with torch.no_grad():
        a = make_prefill_step(model, mesh)(params, prompt_of(batches[0]))
        b = make_prefill_step(model, None)(params, prompt_of(batches[0]))
    assert all(torch.equal(x, y) for x, y in zip([a[0].to_local()] + cache_tensors(a[1]),
                                                 [b[0]] + cache_tensors(b[1]), strict=True))


@pytest.mark.parametrize(("case", "dtype"), [(c, d) for c in FAMILIES
                                             for d in ("bfloat16", "float32")])
def test_families_sharded_step_on_four_gloo_ranks_matches_one_device(case, dtype, tmp_path):
    """3 sharded steps and a prefill of the global batch on a 2 x 2 mesh
    against one device: in bfloat16 within ``torch_tp_case.FAMILY_BF16``
    (TINY's bounds do not hold there; see its measured gaps), in float32
    within TINY's bounds, and the float32 witness: the first step's
    gradients, every loss and the first step's grad norm within 1e-5
    relative (measured at most 3.0e-6, 2.4e-6 and 1.1e-7; the grad norms
    of steps 2-3 within 1e-3: AdamW's first updates, about lr x sign(g),
    move a near-zero gradient element's param by up to 2 lr where its
    float32 rounding differs, measured 1.4e-5 at step 3 on seamless).
    Every rank ends with the same state, and each holds every leaf as its
    spec's shard (heads, width, ffn and vocab split over "model")."""
    g = gaps(run_workers(tmp_path, case, dtype), case, dtype)
    assert within(g, dtype, case), {k: v for k, v in g.items() if k != "local_shapes"}
    if dtype == "float32":
        assert max([g["grad"], *g["loss_rel"], g["gnorm_rel"][0]]) <= F32_REL, g
    model, params, _ = setup(case)
    _local_shapes_are_the_specs(g, model, params, (2, 2))


@pytest.mark.parametrize("case", FAMILIES)
def test_families_match_the_references_sharded_step(case, tmp_path):
    """Each family's step on 4 gloo ranks against the reference's jitted
    with its param_specs shardings on a 2 x 2 Auto-axis mesh of 4 host
    devices, within the dense case's bounds."""
    _against_the_reference(case, tmp_path)


@pytest.mark.parametrize("step", ["train", "prefill"])
def test_uneven_vocabulary_on_a_model_only_mesh(step):
    """A vocabulary of 510 (padded to a multiple of 2) that a model axis of
    4 does not divide: the rules map ``vocab`` to "model" as
    ``make_rules`` does, and the sharded step raises ``ValueError`` naming
    the table and the mesh before any collective, as JAX refuses the
    reference's ``P("model", "data")`` there (rank 0 of a fake world of 4)."""
    model, params, batches = setup("uneven")
    am = abstract_mesh((1, 4), ("data", "model"))
    assert tuple(param_specs(params, model.cfg, am)["embed"]) == ("model", "data")
    assert TS._step_rules(am, model.cfg, None).resolve("vocab") == "model"
    with fake_world(4):
        mesh = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
        with pytest.raises(ValueError, match=r"embed: .* 4 ways.*'model': 4"):
            if step == "train":
                make_train_step(model, mesh, AdamWConfig(**OPT))(params, adamw_init(params),
                                                                 batches[0])
            else:
                make_prefill_step(model, mesh)(params, prompt_of(batches[0]))


def test_cross_prefill_cache_runs_on_one_device_only(one_rank):
    """``cross_prefill_cache`` (no sharded step calls it: the steps make
    the cross caches in the block's prefill) computes every kv head on one
    device and raises under a sharded step's rules, even on one rank."""
    model, params, _ = setup("vlm")
    cfg = model.cfg
    block = T.block_init(torch.Generator().manual_seed(7), cfg, cfg.n_layers - 1, "cross")
    src = torch.randn((2, cfg.vision_tokens, cfg.d_model),
                      generator=torch.Generator().manual_seed(8))
    cache = T.cross_prefill_cache(block, src, cfg)
    assert cache.k.shape == (2, cfg.vision_tokens, cfg.n_kv_heads, cfg.resolved_head_dim)
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    with axis_rules(TS._step_rules(mesh, cfg, Shards(mesh, cfg))), pytest.raises(ConfigError):
        T.cross_prefill_cache(block, src, cfg)
