"""Query heads split unevenly over ``"model"`` (``force_head_sharding``:
llama4-maverick-400b-a17b's 40 heads on a 16-way axis) in the port's
sharded train, prefill and decode steps, on the CPU.

The reference maps ``heads`` to ``"model"`` under the flag whether or not
the axis divides them, and GSPMD tiles the heads in tiles of ceil(n / m),
padded at the end: on 16 ranks, 3 heads each on ranks 0-12, head 39 on
rank 13, none on 14-15.  The port computes each rank's tile
(``parallel.collectives.head_range``): ``wq`` and ``wo`` gathered whole
over ``"model"`` and read for the tile's heads, their gradients summed; a
rank with no heads launches no attention kernel and still makes every
collective of the others.

* ``head_range`` for 40 heads over 16 and 8 ranks, and every configured
  model's heads on 16 ranks (where they divide: today's ``r * hl``).
* ``_step_rules`` for llama4 on abstract (16, 16) and (2, 16, 16) meshes:
  ``heads`` on ``"model"``, ``kv_heads`` whole; without the flag both
  whole.  MLA and RWKV6 heads that the axis does not divide are refused.
* The reduced llama4 (``tests/torch_tp_case.py``'s ``HEADS_CASES``,
  ``force_head_sharding`` and ``moe_ep`` as configured, every expert
  routed) on 4 gloo ranks against one device, in bfloat16 within
  ``FAMILY_BF16`` and in float32 within the dense bounds and the 1e-5
  witness: 3 train steps and a prefill, then a prefill and 6 decode steps
  over caches split by sequence.  6 heads over 2 kv heads on (1, 4): the
  ranks hold 2, 2, 2, 0 heads, rank 1's two heads read kv heads 0 and 1;
  5 heads over 1 kv head on (2, 2): 3 and 2, a rank's ``wq`` shard of 2.5
  heads ends inside a head.  Each rank records the head counts it ran.
* The (1, 4) case's step held to the reference's jitted EP step with its
  shardings on a (1, 4) Auto-axis mesh of 4 host devices, within the dense
  bounds of ``tests/test_torch_tensor_parallel.py``.
* A one-rank (1, 1) mesh: 3 train steps, a prefill and the decode steps
  bit-equal to one device.

All multi-rank cases run on one launch of 4 gloo processes under a timeout
of their own (:data:`TIMEOUT`): a rank that missed a collective would hang
the others.
"""
import dataclasses
import json
import types

import numpy as np
import pytest
import torch
from torch.distributed.device_mesh import init_device_mesh
from test_torch_tensor_parallel import (F32_REL, finish_reference, hold_to_reference,
                                        start_reference)
from test_torch_tensor_parallel_families import _local_shapes_are_the_specs
from torch_dist_helpers import dist_guard, one_rank, run_ranks, whole  # noqa: F401
from torch_tp_case import (HEADS_CASES, OPT, chain_gaps, compute_in, decode_chain,
                           decode_reference, gaps, prompt_of, recording_heads, run, setup, within)

import repro_torch.configs as PC
from repro_torch.core.errors import ConfigError
from repro_torch.parallel.collectives import head_range
from repro_torch.parallel.sharding import abstract_mesh
from repro_torch.training import (AdamWConfig, make_decode_step, make_prefill_step,
                                  make_train_step)
from repro_torch.training import train_step as TS
from repro_torch.training._tree import leaves

LLAMA4 = "llama4-maverick-400b-a17b"
TIMEOUT = 150  # seconds for the launch of 4 ranks (about 45 s here)
DTYPES = ("bfloat16", "float32")
# each case's query heads a model rank, by model index
TILES = {"heads6": [2, 2, 2, 0], "heads5": [3, 2]}


def _sh(m: int, r: int):
    return types.SimpleNamespace(sizes={"model": m}, index={"model": r})


def _tiles(n: int, m: int) -> list:
    return [head_range(n, _sh(m, r)) for r in range(m)]


def test_head_range_is_gspmds_padded_tiling():
    assert _tiles(40, 16) == [(3 * r, 3) for r in range(13)] + [(39, 1), (40, 0), (40, 0)]
    assert _tiles(40, 8) == [(5 * r, 5) for r in range(8)]
    assert _tiles(6, 4) == [(0, 2), (2, 2), (4, 2), (6, 0)]
    assert _tiles(5, 2) == [(0, 3), (3, 2)]
    for arch in PC.ARCHS:
        n = PC.get_config(arch).n_heads
        tiles = _tiles(n, 16)
        assert [h for h0, hl in tiles for h in range(h0, h0 + hl)] == list(range(n)), arch
        if n % 16 == 0:
            assert tiles == [(r * (n // 16), n // 16) for r in range(16)], arch
        else:
            assert arch == LLAMA4


@pytest.mark.parametrize("mesh", [(16, 16), (2, 16, 16)], ids=["16x16", "2x16x16"])
def test_step_rules_split_llama4s_heads_unevenly(mesh):
    cfg = PC.get_config(LLAMA4)
    am = abstract_mesh(mesh, ("pod", "data", "model")[-len(mesh):])
    rules = TS._step_rules(am, cfg, None)
    assert (rules.resolve("heads"), rules.resolve("kv_heads")) == ("model", None)
    rules = TS._step_rules(am, dataclasses.replace(cfg, force_head_sharding=False), None)
    assert (rules.resolve("heads"), rules.resolve("kv_heads")) == (None, None)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "rwkv6-1.6b"])
def test_uneven_mla_and_rwkv_heads_are_refused(arch):
    """MLA's and RWKV6's heads split only where "model" divides them."""
    cfg = dataclasses.replace(PC.get_config(arch), force_head_sharding=True)
    heads = cfg.d_model // cfg.rwkv_head_dim if cfg.family == "ssm" else cfg.n_heads
    am = abstract_mesh((1, heads + 1), ("data", "model"))
    with pytest.raises(ConfigError, match="force_head_sharding"):
        TS._step_rules(am, cfg, None)


@pytest.fixture(scope="module")
def heads_runs(tmp_path_factory):
    """Every HEADS_CASES case in both compute dtypes, and the (1, 4) case's
    step from the reference's params, on one launch of 4 gloo ranks (the
    reference's step in a subprocess beside them); one device's decode
    chains first, whose tokens the ranks feed."""
    d = tmp_path_factory.mktemp("uneven_heads")
    for case in HEADS_CASES:
        for dtype in DTYPES:
            (d / case / dtype).mkdir(parents=True)
            with compute_in(dtype):
                decode_reference(d / case / dtype, case)
    (d / "ref").mkdir()
    ref = start_reference("heads6", d / "ref", HEADS_CASES["heads6"])
    body = "from torch_tp_case import heads_rank, train_rank\n" + "".join(
        f"heads_rank(d + '/{case}', rank, {case!r}, {mesh})\n"
        for case, mesh in HEADS_CASES.items())
    body += f"train_rank(d + '/ref', rank, 'heads6', 'bfloat16', 1, {HEADS_CASES['heads6']})\n"
    try:
        run_ranks(body, 4, d, timeout=TIMEOUT)
    finally:
        finish_reference(ref, d / "ref")
    return d


def _heads(d, case: str) -> list:
    """Each rank's recorded head counts, in rank order."""
    return [json.loads((d / f"heads{r}.json").read_text()) for r in range(4)]


def _tile_of(case: str, rank: int) -> int:
    m = HEADS_CASES[case][1]
    return TILES[case][rank % m]  # a ("data", "model") mesh: model index = rank % m


@pytest.mark.parametrize(("case", "dtype"), [(c, t) for c in HEADS_CASES for t in DTYPES])
def test_uneven_heads_train_and_prefill_match_one_device(case, dtype, heads_runs):
    """bfloat16 within ``FAMILY_BF16`` (measured heads6 / heads5:
    gradients 2.0% / 2.7%, params 5.4% / 5.0%, movement 5.8% / 3.7%, grad
    norms <= 1.7e-4 / 2.7e-3), float32 within the dense bounds and its
    gradients, losses and first grad norm within 1e-5 (measured at most
    1.3e-6); every rank holds the same state and its leaves as the specs'
    shards, and ran the heads of its tile only; the rank with none made
    every step and called no attention kernel."""
    d = heads_runs / case / dtype
    g = gaps([np.load(d / f"out{r}.npz") for r in range(4)], case, dtype)
    assert within(g, dtype, case), {k: v for k, v in g.items() if k != "local_shapes"}
    if dtype == "float32":
        assert max([g["grad"], *g["loss_rel"], g["gnorm_rel"][0]]) <= F32_REL, g
    model, params, _ = setup(case)
    _local_shapes_are_the_specs(g, model, params, HEADS_CASES[case])
    for r, h in enumerate(_heads(d, case)):
        assert h["train"] == [_tile_of(case, r)] and h["calls"] > 0, (r, h)
        assert (h["flash"] > 0) == (_tile_of(case, r) > 0), (r, h)  # none on an empty tile


@pytest.mark.parametrize(("case", "dtype"), [(c, t) for c in HEADS_CASES for t in DTYPES])
def test_uneven_heads_decode_matches_one_device(case, dtype, heads_runs):
    """The prefill and 6 decode steps over caches split by sequence: every
    rank's logits and caches within LOGIT_TOL and CACHE_TOL of one device's
    in bfloat16 (measured at most 0.055 and 0.039 apart), within 1e-5 of
    each tensor's largest |value| in float32 (measured 9.3e-7); the same on
    every rank; one merge a layer a step; each rank's queries its tile's
    heads."""
    d = heads_runs / case / dtype
    want = np.load(d / "one.npz")
    outs = [np.load(d / f"dec{r}.npz") for r in range(4)]
    for o in outs:
        assert all(np.array_equal(o[k], outs[0][k]) for k in o.files)
    g = chain_gaps(outs[0], want)
    assert g["same_tokens"] and g["logits_within"] and g["caches_within"], g
    if dtype == "float32":
        assert max(g["logits_rel"], g["caches_rel"]) <= F32_REL, g
    n_layers = setup(case)[0].cfg.n_layers
    for r, h in enumerate(_heads(d, case)):
        assert h["decode"] == [_tile_of(case, r)] and h["merges"] == n_layers * 6, (r, h)


def test_uneven_heads_match_the_references_sharded_step(heads_runs):
    """One step of the (1, 4) case against the reference's jitted EP step
    under its rules with the flag (GSPMD pads 6 heads to 8 over 4 ranks),
    within the dense bounds (measured: loss 3.6e-4 apart, grad norm 2.3e-3
    relative, gradients 3.3% of a leaf's largest, params 2.0 x lr where an
    update took the other sign)."""
    got = np.load(heads_runs / "ref" / "out0.npz")
    hold_to_reference(got, np.load(heads_runs / "ref" / "ref_out.npz"))


@pytest.mark.parametrize("case", list(HEADS_CASES))
def test_one_rank_mesh_is_bit_equal_to_one_device(case, one_rank):
    """3 train steps, a prefill and 6 decode steps of the reduced llama4 on
    a (1, 1) mesh: every state leaf, metric, logit and cache bit-equal to
    one device (one rank holds every head)."""
    model, params, batches = setup(case)
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    opt = AdamWConfig(**OPT)
    with recording_heads() as heads:
        got = run(make_train_step(model, mesh, opt), params, batches)
    assert set(heads) == {model.cfg.n_heads}
    want = run(make_train_step(model, None, opt), params, batches)
    assert all(torch.equal(a, b) for a, b in zip(whole(got[:2]), leaves(want[:2]), strict=True))
    for g, w in zip(got[2], want[2]):
        assert list(g) == list(w) and all(torch.equal(g[k], w[k]) for k in w)
    prompt = prompt_of(batches[0])["tokens"][:, :4]
    a = decode_chain(model, params, make_prefill_step(model, mesh), make_decode_step(model, mesh),
                     prompt)
    b = decode_chain(model, params, make_prefill_step(model, None),
                     make_decode_step(model, None), prompt)
    assert all(torch.equal(x, y) for x, y in zip(_chain(a), _chain(b), strict=True))


def _chain(c) -> list:
    """A ``decode_chain`` result's tensors: the prefill's logits and
    caches, each step's logits, the tokens fed, the final caches."""
    logits, pref, outs, fed, caches = c
    return [logits, *pref, *outs, fed, *caches]
