"""The port's serve steps on a DeviceMesh in the reference's decode layout,
on the CPU.

``make_prefill_step`` and ``make_decode_step`` on a mesh take the global
batch and slice dim 0 over the batch axes, as the train step does.  They
return DTensors of the global shapes: the logits as this rank's rows, the
caches as this rank's pieces under ``cache_specs`` (batch over ``"data"``,
the cache's sequence over ``"model"``).  The decode runs every
family's tensor parallelism (heads, width, ffn and vocab over ``"model"``),
attends over its piece of the sequence, and merges the ranks' partial
softmaxes over ``"model"`` (flash-decoding).  The cases
(``tests/torch_tp_case.py`` holds them, and ``chip_smoke.py``'s phase 16
runs some of them):

* A one-rank (1, 1) mesh: a prefill, then 4 decode steps, bit-equal to one
  device for reduced configs of the dense (``TINY``), MLA
  (deepseek-v2-lite-16b), RG-LRU (recurrentgemma-9b), RWKV6 (rwkv6-1.6b),
  VLM (llama-3.2-vision-11b) and encoder-decoder (seamless-m4t-medium)
  families.  Every cache is whole on one rank, so each layer attends as
  one device does.
* A ("data" 2, "model" 1) mesh on 2 gloo ranks: each rank's prefill of the
  global batch of 8 equals one device's prefill of that rank's 4 rows, and
  a decode step of the global batch equals one device's step on those rows,
  bit for bit.  Before this layout, each rank ran all 8 rows.
* A 2 x 2 mesh on 4 gloo ranks, ``TINY`` with 1 kv head (replicated over
  ``"model"``) and 2 (split): a prefill of the global batch, the caches
  grafted into buffers of 16 positions, then 6 decode steps.  The first
  step (slot 4) leaves model rank 1's piece (slots 8-15) with no written
  slot, slots 7 and 8 sit either side of the boundary, and slot 9 lands in
  rank 1's piece.  Each step's logits and the caches are within
  ``LOGIT_TOL`` / ``CACHE_TOL`` of one device and of the reference's decode
  step, jitted with its ``param_specs`` and ``cache_specs`` shardings on a
  2 x 2 Auto-axis mesh of 4 host devices (a subprocess with its own
  ``XLA_FLAGS``).  Both ports start from the reference's params and feed
  the tokens the reference chose greedily.  Measured (1 / 2 kv heads): the
  ranks' logits 0.0063 / 0.0068 off one device, caches 0.031 / 0.031;
  off the reference 0.0078 / 0.0063 and 0.027 / 0.039, where one device
  is 0.0078 / 0.0065 and 0.031 / 0.040 off it (bf16 rounding of split
  contractions).  The merge keeps its partials in float32: rounded to
  bf16 as ``_sdpa`` rounds its probabilities, one cache element came
  0.055 off the reference, past CACHE_TOL.
* A (1, 2) model-only mesh on 2 gloo ranks, each case against one device,
  with the merges a step counted: MLA's latent merge on its split heads
  (the absorbed queries gathered), recurrentgemma's local ring (32 slots,
  16 a rank) wrapping from rank 1's piece to rank 0's with its RG-LRU split
  by width, the VLM's cross cache (16 vision tokens, 8 a rank) under split
  cross-attention, the RWKV6 state split by heads, seamless's decoder, the
  masked cache write, and a buffer of 15 that ``"model"`` does not divide
  (kept whole on both ranks, no merge).  In bfloat16 every case holds
  LOGIT_TOL, and CACHE_TOL but for ``torch_tp_case.CACHE_REL_CASES`` (the
  ring, the VLM and RWKV6), whose caches hold ``FAMILY_BF16``'s 3% of each
  cache's largest |value|: their split compute parts 1 to 7 elements of a
  deep cache from one device's by up to about 5 bf16 ulps past CACHE_TOL
  (the rounding of split sums carried through the layers).  The same
  chains in float32 compute
  hold every logit and cache within ``F32_REL`` (1e-5) of the largest
  |value| of its tensor, the witness that the bfloat16 gaps are rounding.
  Measured, bfloat16 logits / caches off one device (max |diff|, and of
  the largest |value|), then float32 (the worst, relative): MLA 0.053 /
  0.035 (1.1%), 7.9e-7; the ring 0.086 / 0.066 (1.8%), 1.1e-6; the VLM
  0.082 / 0.070 (1.9%), 1.0e-6; RWKV6 0.063 / 0.109 (0.95%, its float32
  WKV state), 5.7e-7; seamless 0.047 / 0.031 (0.86%), 7.3e-7; masked
  0.0068 / 0.031, 8.9e-7; the buffer of 15 0.0083 / 0.027, 7.8e-7.  In
  decode neither the RG-LRU nor the RWKV6 block gathers its state: a
  counter of their ``all_gather`` inputs finds none of a state's shape
  and dtype, and one gather an activation a block a step (the RG-LRU's
  conv output for its gates, RWKV6's ``cm_r`` output).  Also the merge alone in float32 where
  one rank's piece holds no valid key: its exp(m - M) is 0, and the result
  equals ``_sdpa`` over the whole.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch_dist_helpers import ROOT, RANK_TIMEOUT, dist_guard, one_rank, run_ranks  # noqa: F401
from test_torch_tensor_parallel import F32_REL
from torch_tp_case import (CACHE_REL_CASES, CHAIN_DTYPES, DECODE_LEN, DECODE_STEPS, FAMILY_BF16,
                           MERGES_A_STEP, MODEL_CASES, MODEL_WORKER, PROMPT, TINY, cache_tensors,
                           chain_gaps, compute_in, decode_chain, decode_gaps, decode_inputs,
                           empty_piece_inputs, family_case, graft, save_chain, setup)

from repro_torch.models import layers as L
from repro_torch.training import make_decode_step, make_prefill_step

FAMILIES = {"dense": None, "mla": "deepseek-v2-lite-16b", "rglru": "recurrentgemma-9b",
            "rwkv6": "rwkv6-1.6b", "vlm": "llama-3.2-vision-11b",
            "seamless": "seamless-m4t-medium"}
EMPTY_PIECE_TOL = 1e-6  # float32: the merge against _sdpa over every key


def _bits(chain) -> list:
    logits, pref, outs, fed, caches = chain
    return [logits, *pref, *outs, fed, *caches]


@pytest.mark.parametrize("family", FAMILIES)
def test_one_rank_mesh_decodes_bit_equal_to_one_device(family, one_rank):
    model, params, batch = family_case(FAMILIES[family], {}, 12)
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    got = decode_chain(model, params, make_prefill_step(model, mesh),
                       make_decode_step(model, mesh), batch, steps=4, length=24)
    want = decode_chain(model, params, make_prefill_step(model, None),
                        make_decode_step(model, None), batch, steps=4, length=24)
    assert all(torch.equal(a, b) for a, b in zip(_bits(got), _bits(want), strict=True))


# each rank's prefill of the global batch and one decode step of it on a
# ("data" 2, "model" 1) mesh, saved as this rank's local pieces
_DATA_WORKER = """
    import dataclasses
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.training import make_decode_step, make_prefill_step
    from torch_tp_case import DECODE_LEN, PROMPT, decode_inputs, graft

    def local(caches):
        if isinstance(caches, dict):
            return [t for k in sorted(caches) for t in local(caches[k])]
        if isinstance(caches, list):
            return [t for c in caches for t in local(c)]
        return [getattr(caches, f.name).to_local() for f in dataclasses.fields(caches)]

    model, params, prompt, _ = decode_inputs(1, d)
    mesh = init_device_mesh("cpu", (2, 1), mesh_dim_names=("data", "model"))
    with torch.no_grad():
        logits, caches = make_prefill_step(model, mesh)(params, {"tokens": prompt})
        dec = model.make_decode_caches(prompt.shape[0], DECODE_LEN, device="cpu")
        graft(dec, caches, PROMPT)
        out, dec = make_decode_step(model, mesh)(params, prompt[:, -1:], dec, PROMPT)
    np.savez(f"{d}/out{rank}.npz", logits=logits.to_local().float().numpy(),
             step=out.to_local().float().numpy(),
             **{f"c{i}": t.float().numpy() for i, t in enumerate(local(caches))},
             **{f"d{i}": t.float().numpy() for i, t in enumerate(local(dec))})
"""


def test_serve_steps_take_the_global_batch_and_run_this_ranks_rows(tmp_path):
    run_ranks(_DATA_WORKER, 2, tmp_path)
    model, params, prompt, _ = decode_inputs(1, tmp_path)
    for r in range(2):
        rows = prompt[4 * r:4 * r + 4]
        with torch.no_grad():
            logits, caches = make_prefill_step(model, None)(params, {"tokens": rows})
            dec = model.make_decode_caches(4, DECODE_LEN, device="cpu")
            graft(dec, caches, PROMPT)
            out, dec = make_decode_step(model, None)(params, rows[:, -1:], dec, PROMPT)
        got = np.load(tmp_path / f"out{r}.npz")
        assert got["logits"].shape[0] == got["step"].shape[0] == 4
        np.testing.assert_array_equal(got["logits"], logits.float().numpy())
        np.testing.assert_array_equal(got["step"], out.float().numpy())
        for key, tree in (("c", caches), ("d", dec)):
            for i, t in enumerate(cache_tensors(tree)):
                np.testing.assert_array_equal(got[f"{key}{i}"], t.float().numpy())


# the reference's prefill of the prompt (jitted on one device), its caches
# grafted into decode buffers, then its decode step jitted with param_specs
# and cache_specs shardings on a 2 x 2 Auto-axis mesh of 4 host devices,
# greedy; saved as torch_tp_case.save_chain saves a chain, with the params
_REF_DECODE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec
from repro.configs.base import ModelConfig
from repro.models import build_model
from repro.parallel.partition import param_specs
from repro.training.train_step import cache_specs, make_decode_step
d, tiny, length, steps = sys.argv[1], eval(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
model = build_model(ModelConfig(**tiny))
params = model.init(jax.random.PRNGKey(0))
prompt = jnp.asarray(np.load(f"{d}/prompt.npy"))
b, p = prompt.shape
logits, pref = jax.jit(model.prefill)(params, {"tokens": prompt})
dec = jax.tree.map(lambda a, c: a.at[:, :, :p].set(c.astype(a.dtype)),
                   model.make_decode_caches(b, length), pref)
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)

def named(specs):
    return jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                        is_leaf=lambda x: isinstance(x, PartitionSpec))

with mesh:
    step = jax.jit(make_decode_step(model, mesh),
                   in_shardings=(named(param_specs(params, model.cfg, mesh)),
                                 NamedSharding(mesh, PartitionSpec("data", None)),
                                 named(cache_specs(dec, mesh, "data")),
                                 NamedSharding(mesh, PartitionSpec())))
    tok, fed, outs = logits[:, -1].argmax(-1)[:, None].astype(jnp.int32), [], []
    for i in range(steps):
        fed.append(tok)
        out, dec = step(params, tok, dec, jnp.int32(p + i))
        outs.append(out)
        tok = out[:, -1].argmax(-1)[:, None].astype(jnp.int32)

def f32(a):
    a = np.asarray(a)
    return a if a.dtype == np.int32 else a.astype(np.float32)

np.savez(f"{d}/ref.npz", logits=f32(logits), fed=np.stack([np.asarray(t) for t in fed]),
         **{f"p{i}": f32(t) for i, t in enumerate(jax.tree.leaves(pref))},
         **{f"s{i}": f32(t) for i, t in enumerate(outs)},
         **{f"c{i}": f32(t) for i, t in enumerate(jax.tree.leaves(dec))})
np.savez(f"{d}/params.npz", *[np.asarray(t) for t in jax.tree.leaves(params)])
"""


@pytest.mark.parametrize("kv", [1, 2])
def test_decode_on_four_gloo_ranks_matches_one_device_and_the_reference(kv, tmp_path):
    tiny = dict(TINY, n_kv_heads=kv)
    _, _, batches = setup(kv)
    np.save(tmp_path / "prompt.npy", batches[0]["tokens"][:, :PROMPT].numpy())
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.run([sys.executable, "-c", _REF_DECODE, str(tmp_path), repr(tiny),
                          str(DECODE_LEN), str(DECODE_STEPS)],
                         env=env, capture_output=True, text=True, timeout=RANK_TIMEOUT)
    assert ref.returncode == 0, ref.stdout + ref.stderr
    want = np.load(tmp_path / "ref.npz")
    np.save(tmp_path / "forced.npy", want["fed"])
    g = decode_gaps(tmp_path, kv)  # one device and 4 ranks, fed the reference's tokens
    assert g["within"], g
    for name in ("dec0", "one"):
        r = chain_gaps(np.load(tmp_path / f"{name}.npz"), want)
        assert r["same_tokens"] and r["logits_within"] and r["caches_within"], (name, r)


def test_model_only_mesh_cases_match_one_device(tmp_path):
    for dtype, tag in CHAIN_DTYPES.items():
        with compute_in(dtype):
            for name, (arch, changes, prompt, length, steps) in MODEL_CASES.items():
                model, params, batch = family_case(arch, changes, prompt)
                chain = decode_chain(model, params, make_prefill_step(model, None),
                                     make_decode_step(model, None), batch, None, steps, length)
                save_chain(tmp_path / f"{name}{tag}.npz", chain)
                np.save(tmp_path / f"forced_{name}{tag}.npy", chain[3].numpy())
    run_ranks(MODEL_WORKER, 2, tmp_path)
    for name, (arch, _, _, _, steps) in MODEL_CASES.items():
        want = np.load(tmp_path / f"{name}.npz")
        for r in range(2):
            g = chain_gaps(np.load(tmp_path / f"{name}{r}.npz"), want)
            caches = (g["caches_rel"] <= FAMILY_BF16["caches"] if name in CACHE_REL_CASES
                      else g["caches_within"])
            assert g["same_tokens"] and g["logits_within"] and caches, (name, r, g)
            w = chain_gaps(np.load(tmp_path / f"{name}{r}_f32.npz"),
                           np.load(tmp_path / f"{name}_f32.npz"))
            assert w["same_tokens"] and max(w["logits_rel"], w["caches_rel"]) <= F32_REL, (name, w)
            merges = int(np.load(tmp_path / f"{name}_merges{r}.npy"))
            assert merges == MERGES_A_STEP[name] * steps, (name, merges)
            blocks, gathers, of_states = np.load(tmp_path / f"{name}_gathers{r}.npy").tolist()
            assert of_states == 0, (name, gathers)  # the split blocks read their own pieces
            if name in ("ring", "rwkv6"):  # one gather of an activation a block a step
                assert blocks == 2 * steps == gathers, (name, blocks, gathers)
    q, k, v, mask = empty_piece_inputs()
    whole = L._sdpa(q, k, v, mask)
    for r in range(2):
        got = torch.from_numpy(np.load(tmp_path / f"empty{r}.npy"))
        assert float((got - whole).abs().max()) <= EMPTY_PIECE_TOL
