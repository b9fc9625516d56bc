"""The reduced dense case of the sharded steps on 4 gloo ranks, shared by
``tests/test_torch_tensor_parallel.py`` and ``chip_smoke.py``'s phase 16
(c): the config, the batches, the bounds, the ranks' worker and the
measured gaps to the port's one-device step.  Imports nothing of JAX.

``TINY`` is 2 layers, d_model 64, 4 heads of 16, ``qk_norm``, tied
embeddings, vocab 512, in two cases: 1 kv head, which the 2-way
``"model"`` axis does not divide (the rules replicate it: each rank
gathers ``wk``/``wv`` whole and reads the kv head of its query heads), and
2 kv heads, which it splits.  :data:`WORKER` runs ``STEPS`` sharded steps
of the global batch of 8 x 32 on a ("data", "model") mesh of 2 x 2, then a
prefill of the global batch, in the model's compute dtype (bfloat16) or
in float32 (:func:`compute_in`), and saves the whole state, the first
step's mean gradient, the metrics, the prefill's logits and caches made
whole and this rank's local shard shapes; :func:`gaps` holds them against
the one-device step in the same compute dtype.

The decode case (:data:`DECODE_WORKER`, :func:`decode_gaps`): on the same
2 x 2 mesh, a prefill of the global batch's first ``PROMPT`` tokens, its
caches made whole and grafted into decode buffers of ``DECODE_LEN``
positions, then ``DECODE_STEPS`` steps of the sharded decode step, which
holds the buffers' sequence split over ``"model"`` (positions 0-7 on model
rank 0, 8-15 on rank 1): the first step (slot 4) leaves rank 1's piece with
no written slot, slots 7 and 8 sit either side of the boundary, and slot 9
lands in rank 1's piece.  The tokens fed are given (the reference's
greedy choices) or greedy on one device; each step's logits and the final
caches within LOGIT_TOL and CACHE_TOL of one device's.

The bounds (``tests/test_torch_train_step.py``'s for the port against the
reference): the first step's gradient (the ranks' mean, before the clip)
within 6% of each leaf's largest |gradient|; after the steps each param
within 6% of its leaf's largest |value| and each leaf's mean |difference|
within 5% of its mean movement; each step's loss within 1e-3 relative;
the grad norm within 1e-3 relative at step 1 (the same params) and, in
bfloat16, 2e-3 at steps 2-3 (``tests/test_torch_mesh.py``'s bound for the
data-parallel step): the ranks' bf16 products over split contractions
round otherwise than one device's, and AdamW's first updates, about lr x
sign(g), carry the difference on.  The same steps in float32 compute hold
1e-3 at every step (:data:`GNORM_REL`), which is what separates that
rounding from a fault of the tensor-parallel step.  The prefill's logits
and caches within ``tests/test_torch_models.py``'s LOGIT_TOL and
CACHE_TOL.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import pathlib

import numpy as np
import torch

import repro_torch.configs as PC
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.training import (AdamWConfig, adamw_init, make_decode_step, make_prefill_step,
                                  make_train_step)
from repro_torch.training import train_step as TS
from repro_torch.training._tree import leaves

from torch_dist_helpers import recording_update, run_ranks

TINY = dict(name="lm-tiny-tp", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
            d_ff=256, vocab_size=512, head_dim=16, tie_embeddings=True, qk_norm=True)
OPT = dict(lr=1e-3, warmup_steps=2, decay_steps=10)
STEPS = 3
GRAD_REL = 0.06  # of each leaf's largest |value| (tests/test_torch_train_step.py)
MOVED_REL = 0.05  # a leaf's mean |difference| over its mean movement
LOSS_REL = 1e-3
# each step's grad norm, relative: step 1 (the same params), then steps 2-3
GNORM_REL = {"bfloat16": (1e-3, 2e-3, 2e-3), "float32": (1e-3, 1e-3, 1e-3)}
LOGIT_TOL = dict(atol=0.1, rtol=0.05)  # tests/test_torch_models.py
CACHE_TOL = dict(atol=0.05, rtol=0.02)
PROMPT, DECODE_LEN, DECODE_STEPS = 4, 16, 6  # the decode case: slots 4 .. 9 of 16
# the (1, 2) model-only cases: (arch, None for TINY; config changes; prompt,
# decode buffer, steps) and the merges a decode step makes (one a layer whose
# caches are split: MLA's two, the ring's one local layer, the VLM's five
# self caches and its cross cache, seamless's two; none for RWKV's state,
# which its split heads read as they hold it, nor for a buffer of 15, which
# the axis does not divide)
MODEL_CASES = {
    "mla": ("deepseek-v2-lite-16b", {}, 6, 16, 4),  # slots 6 .. 9 over the boundary at 8
    "ring": ("recurrentgemma-9b", {}, 30, 40, 4),  # a ring of 32: slots 30, 31, then 0, 1
    "cross": ("llama-3.2-vision-11b", {}, 6, 16, 4),  # 16 vision tokens, 8 a rank
    "rwkv6": ("rwkv6-1.6b", {}, 6, 16, 4),  # 4 WKV heads, 2 a rank
    "masked": (None, {"masked_cache_update": True}, 6, 16, 4),
    "undivided": (None, {"n_kv_heads": 2}, 6, 15, 4),
    "seamless": ("seamless-m4t-medium", {}, 6, 16, 4),  # its 2 decoder layers
}
MERGES_A_STEP = {"mla": 2, "ring": 1, "cross": 6, "rwkv6": 0, "masked": 2, "undivided": 0,
                 "seamless": 2}
# the (1, 2) chains' compute dtypes and their files' tags: the port's
# bfloat16, and float32, the witness that the bfloat16 gaps are rounding
CHAIN_DTYPES = {"bfloat16": "", "float32": "_f32"}
# the (1, 2) cases whose bfloat16 caches are held to FAMILY_BF16's share of
# each cache's largest |value|, not CACHE_TOL: a few elements of a cache
# behind several split layers (the ring's K cache after two RG-LRU blocks,
# the VLM's, RWKV6's float32 WKV state of its second layer) part from one
# device's by more, and the float32 chains of the same cases hold 1e-5
CACHE_REL_CASES = ("ring", "cross", "rwkv6")
# the families' train cases (reduced configs; ``setup`` takes the key):
# MLA with its shared expert on the dense MoE dispatch, RG-LRU with local
# attention, RWKV6 on its chunked WKV (chunks of 8 in a sequence of 32), the
# VLM's cross layer, seamless's encoder, a vocabulary of 510 (a one-rank
# case: a model axis of 4 does not divide it, and the sharded steps refuse
# it there), llama4's uneven head splits (HEADS_CASES), and the
# expert-parallel MoE (EP_CASES: deepseek's moe_ep, each model rank training
# its own experts), routing every expert (top 4 of 4, as "mla": no flips,
# and an aux loss of 1 whose gradient is 0, so the step is one device's
# function on any mesh) and its own top 2 of 4 ("mla_ep_k2": the aux loss's
# router gradient is live; on more than one data rank the reference's EP
# gradient is the mean of the data shards' aux gradients, not the whole
# batch's, so it is held to one device on a model-only mesh, in float32:
# in bf16 its near-uniform router flips under TP's rounding)
# the families' bfloat16 bounds on the 2 x 2 mesh (and llama4's uneven heads
# on 1 x 4 and 2 x 2): TINY's do not hold there, by the rounding of bf16
# partial sums (each rank's row-split product rounded, then their bf16 sum)
# through more layers, recurrences and a shared expert; the float32 witness
# holds every family's first-step gradients and losses within 1e-5, so the
# gaps are rounding.  Measured on this CPU (worst family): first-step
# gradient 8.3% of the leaf's largest |gradient| (the RG-LRU's lam, |g| at
# most 1.1e-3), params 8.2% (RWKV6), movement 6.5% (the VLM), grad norms
# 3.0e-3 / 3.8e-3 / 9.9e-3 (RWKV6), losses 4.0e-4, a cache element 1.5% of
# its cache's largest |value|; the bounds about 1.5x of those
FAMILY_BF16 = dict(grad=0.12, param=0.12, moved=0.10, gnorm=(5e-3, 6e-3, 1.5e-2), caches=0.03)
FAMILY_CASES = {
    "mla": ("deepseek-v2-lite-16b", {"moe_ep": False, "top_k": 4}),
    "mla_ep": ("deepseek-v2-lite-16b", {"top_k": 4}),
    "mla_ep_k2": ("deepseek-v2-lite-16b", {}),
    "rglru": ("recurrentgemma-9b", {}),
    "rwkv6": ("rwkv6-1.6b", {"rwkv_chunked": 8}),
    "vlm": ("llama-3.2-vision-11b", {}),
    "seamless": ("seamless-m4t-medium", {}),
    "uneven": ("seamless-m4t-medium", {"vocab_size": 510, "vocab_pad_multiple": 2}),
    "heads6": ("llama4-maverick-400b-a17b", {"n_heads": 6, "top_k": 4}),
    "heads5": ("llama4-maverick-400b-a17b", {"n_heads": 5, "n_kv_heads": 1, "top_k": 4}),
}
EP_CASES = ("mla_ep", "mla_ep_k2")  # tests/test_torch_moe_ep.py runs them
# llama4's uneven head split (force_head_sharding) and their meshes
# (tests/test_torch_uneven_heads.py runs them): 6 heads over 2 kv heads on
# (1, 4), tiles of 2 (ranks hold 2, 2, 2, 0; rank 1's heads 2-3 read kv
# heads 0 and 1), and 5 over 1 kv head on (2, 2), tiles of 3 (3, 2; a
# rank's wq shard of 2.5 heads ends inside a head); every expert routed
HEADS_CASES = {"heads6": (1, 4), "heads5": (2, 2)}


def setup(case):
    """(model, params, batches) of a train case: ``TINY`` with ``case`` kv
    heads (an int), or the reduced family of ``FAMILY_CASES[case]``."""
    if isinstance(case, str):
        return family_setup(case)
    model = build_model(PC.ModelConfig(**dict(TINY, n_kv_heads=case)))
    params = model.init(0, device="cpu")
    pipe = TokenPipeline(vocab_size=TINY["vocab_size"], batch=8, seq_len=32, seed=5)
    batches = [{k: torch.from_numpy(v) for k, v in pipe.batch_at(s).items()}
               for s in range(STEPS)]
    return model, params, batches


def family_config(case: str):
    arch, changes = FAMILY_CASES[case]
    return dataclasses.replace(PC.reduced_config(PC.ARCHS[arch]), **changes)


def family_batches(cfg, steps: int = STEPS, batch: int = 8, seq: int = 32, seed: int = 5) -> list:
    """``steps`` global batches of ``batch`` x ``seq`` from a numpy
    generator: uniform tokens (every model rank's vocabulary slice is hit)
    and their next tokens as labels; an encoder-decoder's frames take
    ``audio_frames_ratio`` of ``seq`` (the reference's ``input_specs``
    split), a VLM adds its vision embeddings."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        b, s = {}, seq
        if cfg.family == "encdec":
            se = int(seq * cfg.audio_frames_ratio)
            b["frames"] = rng.standard_normal((batch, se, cfg.d_model)).astype(np.float32)
            s -= se
        toks = rng.integers(0, cfg.vocab_size, (batch, s + 1)).astype(np.int32)
        b["tokens"], b["labels"] = toks[:, :-1].copy(), toks[:, 1:].copy()
        if cfg.family == "vlm":
            b["vision"] = rng.standard_normal((batch, cfg.vision_tokens,
                                               cfg.d_model)).astype(np.float32)
        out.append({k: torch.from_numpy(v) for k, v in b.items()})
    return out


def family_setup(case: str):
    model = build_model(family_config(case))
    return model, model.init(0, device="cpu"), family_batches(model.cfg)


def prompt_of(batch: dict) -> dict:
    """A train batch as a prefill's: its inputs without the labels."""
    return {k: v for k, v in batch.items() if k != "labels"}


def run(step, params, batches):
    opt, out = adamw_init(params), []
    for b in batches:
        params, opt, metrics = step(params, opt, b)
        out.append(metrics)
    return params, opt, out


@contextlib.contextmanager
def compute_in(dtype: str):
    """The model layers' compute dtype set to ``dtype`` (``"bfloat16"``, the
    port's, or ``"float32"``) while the block runs."""
    was = L.COMPUTE_DTYPE
    L.COMPUTE_DTYPE = T.COMPUTE_DTYPE = getattr(torch, dtype)
    try:
        yield
    finally:
        L.COMPUTE_DTYPE = T.COMPUTE_DTYPE = was


def cache_tensors(caches) -> list:
    """Every tensor of a cache tree (dicts in sorted key order, lists,
    cache dataclasses in field order), DTensors made whole (a collective)."""
    if isinstance(caches, dict):
        return [t for k in sorted(caches) for t in cache_tensors(caches[k])]
    if isinstance(caches, list):
        return [t for c in caches for t in cache_tensors(c)]
    out = [getattr(caches, f.name) for f in dataclasses.fields(caches)]
    return [t.full_tensor() if hasattr(t, "full_tensor") else t for t in out]


def graft(dec, pref, length: int) -> None:
    """Copy a prefill's caches of ``length`` positions into decode buffers in
    place: a cross cache, a recurrent or a WKV state whole, a KV or latent
    cache's positions at slot = position % buffer (a local ring keeps the
    last ones).  DTensors of the prefill are made whole first."""
    if isinstance(dec, dict):
        for k in dec:
            if k == "cross":
                for a, b in zip(cache_tensors(dec[k]), cache_tensors(pref[k])):
                    a.copy_(b)
            else:
                graft(dec[k], pref[k], length)
        return
    if isinstance(dec, list):
        for d, p in zip(dec, pref):
            graft(d, p, length)
        return
    whole = cache_tensors(pref)
    if not hasattr(dec, "kpos"):  # RecState, RwkvState
        for a, b in zip(cache_tensors(dec), whole):
            a.copy_(b)
        return
    ax = dec.kpos.ndim - 1  # the position axis, after any group and the batch axes
    buf = dec.kpos.shape[ax]
    pos = torch.arange(max(0, length - buf), length, device=dec.kpos.device)
    for a, b in zip(cache_tensors(dec), whole):
        a.index_copy_(ax, pos % buf, b.index_select(ax, pos))


def decode_chain(model, params, prefill, decode, prompt, forced=None, steps: int = DECODE_STEPS,
                 length: int = DECODE_LEN):
    """``prefill`` of ``prompt`` (tokens [B, P], or a batch dict with them),
    its caches grafted into whole decode buffers of ``length``, then
    ``steps`` calls of ``decode`` fed ``forced`` [steps, B, 1] or, where
    None, greedy.  Returns (the prefill's logits, its caches' tensors, each
    step's logits, the tokens fed, the final caches' tensors), every
    DTensor made whole."""
    def whole(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    batch = prompt if isinstance(prompt, dict) else {"tokens": prompt}
    prompt = batch["tokens"]
    with torch.no_grad():
        logits, caches = prefill(params, batch)
        logits, pref = whole(logits), cache_tensors(caches)
        dec = model.make_decode_caches(prompt.shape[0], length, device=prompt.device)
        graft(dec, caches, prompt.shape[1])
        tok = logits[:, -1].argmax(-1, keepdim=True)
        outs, fed = [], []
        for i in range(steps):
            tok = tok if forced is None else forced[i]
            fed.append(tok)
            out, dec = decode(params, tok, dec, prompt.shape[1] + i)
            out = whole(out)
            outs.append(out)
            tok = out[:, -1].argmax(-1, keepdim=True)
    return logits, pref, outs, torch.stack(fed), cache_tensors(dec)


def leaf_names(tree, path=()) -> list:
    """The dotted key paths of ``tree``'s leaves, in its leaf order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [n for i, t in enumerate(tree) for n in leaf_names(t, path + (str(i),))]
    return [".".join(path)]


def train_rank(d, rank: int, case, dtype: str = "bfloat16", steps: int = STEPS,
               mesh: tuple = (2, 2)) -> None:
    """One rank's part of a train case (a ``torch_dist_helpers.run_ranks``
    body calls it): params from ``params.npz`` in ``d`` where given (else
    ``setup(case)``'s), ``steps`` sharded steps on a ("data", "model") mesh
    of ``mesh``, then a prefill of the global batch, in ``dtype`` compute;
    saves the whole state, the first step's mean gradient, the metrics,
    the prefill's logits and caches made whole and this rank's local shard
    shapes to ``d/out<rank>.npz``."""
    from torch.distributed.device_mesh import init_device_mesh

    from torch_dist_helpers import whole, whole_grads
    from repro_torch.training._tree import unflatten

    torch.set_num_threads(1)  # the ranks share the host's cores
    model, params, batches = setup(case)
    if os.path.exists(f"{d}/params.npz"):
        given = np.load(f"{d}/params.npz")
        params = unflatten(params, [torch.from_numpy(given[f"arr_{i}"])
                                    for i in range(len(given.files))])
    seen, update = [], TS._update
    TS._update = recording_update(seen)
    try:
        grid = init_device_mesh("cpu", mesh, mesh_dim_names=("data", "model"))
        with compute_in(dtype):
            p, opt, metrics = run(make_train_step(model, grid, AdamWConfig(**OPT)), params,
                                  batches[:steps])
            with torch.no_grad():
                logits, caches = make_prefill_step(model, grid)(params, prompt_of(batches[0]))
    finally:
        TS._update = update
    grads = whole_grads(model, params, grid, seen[0])
    shapes = {n: list(t.to_local().shape) for n, t in zip(leaf_names(params), leaves(p))}
    np.savez(f"{d}/out{rank}.npz", *[t.numpy() for t in whole((p, opt))],
             **{f"g{i}": g.numpy() for i, g in enumerate(grads)},
             **{f"c{i}": t.float().numpy() for i, t in enumerate(cache_tensors(caches))},
             logits=logits.full_tensor().float().numpy(), shapes=np.array(json.dumps(shapes)),
             loss=np.array([float(m["loss"]) for m in metrics]),
             aux=np.array([float(m["moe_aux"]) for m in metrics]),
             gnorm=np.array([float(m["grad_norm"]) for m in metrics]))


# the worker (torch_dist_helpers.run_ranks' body): one train case
WORKER = """
    from torch_tp_case import train_rank
    train_rank(d, rank, {kv!r}, "{dtype}", {steps}, {mesh})
"""


def run_workers(directory: pathlib.Path, kv, dtype: str = "bfloat16", steps: int = STEPS,
                mesh: tuple = (2, 2)) -> list:
    """:data:`WORKER` on 4 gloo ranks (a ("data", "model") mesh of
    ``mesh``) for the case ``kv`` (``setup``'s); each rank's saved
    arrays."""
    run_ranks(WORKER.format(kv=kv, steps=steps, dtype=dtype, mesh=mesh), 4, directory)
    return [np.load(directory / f"out{r}.npz") for r in range(4)]


def one_device(model, params, batches, dtype: str = "bfloat16"):
    """The one-device step over ``batches`` in ``dtype`` compute, with its
    first mean gradient."""
    seen, update = [], TS._update
    TS._update = recording_update(seen)
    try:
        with compute_in(dtype):
            p, opt, metrics = run(make_train_step(model, None, AdamWConfig(**OPT)), params,
                                  batches)
    finally:
        TS._update = update
    return p, opt, metrics, [g.float().numpy() for g in seen[0]]


def gaps(outs: list, kv, dtype: str = "bfloat16") -> dict:
    """The ranks' saved arrays against the one-device step: the worst
    gradient, param and movement gaps over the leaves, each step's loss and
    grad-norm gap (relative), whether every rank holds the same state, and
    whether every rank's prefill of the global batch is within LOGIT_TOL
    and CACHE_TOL."""
    model, params, batches = setup(kv)
    p, opt, metrics, grads = one_device(model, params, batches, dtype)
    want = [t.float().numpy() for t in leaves((p, opt))]
    got = outs[0]
    same = all(np.array_equal(o[f"arr_{i}"], got[f"arr_{i}"]) for o in outs
               for i in range(len(want)))
    out = {"grad": 0.0, "param": 0.0, "moved": 0.0, "same_state": same}
    for i, g in enumerate(grads):
        assert got[f"g{i}"].shape == g.shape, (i, got[f"g{i}"].shape, g.shape)
        # a leaf whose gradient is 0 (seamless's encoder: no cross layer reads
        # it) is held to 0 itself
        out["grad"] = max(out["grad"], float(np.abs(got[f"g{i}"] - g).max()
                                             / (np.abs(g).max() or 1.0)))
    for i, (p0, w) in enumerate(zip(leaves(params), want)):
        a, moved = got[f"arr_{i}"], np.abs(w - p0.float().numpy()).mean()
        out["param"] = max(out["param"], float(np.abs(a - w).max() / np.abs(w).max()))
        out["moved"] = max(out["moved"], float(np.abs(a - w).mean() / moved) if moved else np.inf)
    loss = np.array([float(m["loss"]) for m in metrics])
    gnorm = np.array([float(m["grad_norm"]) for m in metrics])
    out["loss_rel"] = (np.abs(got["loss"] - loss) / loss).tolist()
    out["gnorm_rel"] = (np.abs(got["gnorm"] - gnorm) / gnorm).tolist()
    with torch.no_grad(), compute_in(dtype):  # every rank's prefill against one device's
        logits, caches = make_prefill_step(model, None)(params, prompt_of(batches[0]))
    want_c = [c.float().numpy() for c in cache_tensors(caches)]
    out["logits_within"] = all(np.allclose(o["logits"], logits.float().numpy(), **LOGIT_TOL)
                               for o in outs)
    out["caches_within"] = all(np.allclose(o[f"c{i}"], c, **CACHE_TOL)
                               for o in outs for i, c in enumerate(want_c))
    out["caches_rel"] = max((float(np.abs(o[f"c{i}"] - c).max() / (np.abs(c).max() or 1.0))
                             for o in outs for i, c in enumerate(want_c)), default=0.0)
    out["prefill_within"] = out["logits_within"] and out["caches_within"]
    out["local_shapes"] = {r: json.loads(str(o["shapes"])) for r, o in enumerate(outs)}
    return out


def bounds(case, dtype: str = "bfloat16") -> dict:
    """The bounds of a train case (``setup``'s): ``TINY``'s above, and for
    a family in bfloat16 :data:`FAMILY_BF16` (the prefill's caches then
    within ``caches`` of each cache's largest |value|, not CACHE_TOL)."""
    b = dict(grad=GRAD_REL, param=GRAD_REL, moved=MOVED_REL, loss=LOSS_REL,
             gnorm=GNORM_REL[dtype], caches=None)
    if isinstance(case, str) and dtype == "bfloat16":
        b.update(FAMILY_BF16)
    return b


def within(g: dict, dtype: str = "bfloat16", case=1) -> bool:
    """Whether :func:`gaps`' ``g`` keeps every bound of ``case``."""
    b = bounds(case, dtype)
    caches = g["caches_within"] if b["caches"] is None else g["caches_rel"] <= b["caches"]
    return (g["same_state"] and g["logits_within"] and caches and g["grad"] <= b["grad"]
            and g["param"] <= b["param"] and g["moved"] <= b["moved"]
            and all(x <= b["loss"] for x in g["loss_rel"])
            and all(x <= y for x, y in zip(g["gnorm_rel"], b["gnorm"], strict=True)))


@contextlib.contextmanager
def _no_card():
    """The environment of worker processes that see no card and take 2
    threads each (put back after)."""
    env = {k: os.environ.get(k) for k in ("CUDA_VISIBLE_DEVICES", "OMP_NUM_THREADS")}
    os.environ.update(CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    try:
        yield
    finally:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def check_in_subprocesses(directory: pathlib.Path, kv, dtype: str = "bfloat16",
                          mesh: tuple = (2, 2)) -> dict:
    """:func:`run_workers` then :func:`gaps`, with the gaps and ``within``;
    the workers see no card."""
    with _no_card():
        outs = run_workers(directory, kv, dtype, mesh=mesh)
    g = gaps(outs, kv, dtype)
    return dict(g, within=within(g, dtype, kv))


def check_cases_in_one_launch(directory: pathlib.Path, train: dict, decode: tuple,
                              compressed: dict | None = None) -> dict:
    """Bfloat16 train cases ``train`` (name -> (``setup``'s case, mesh,
    the case whose bounds hold it)), the decode cases of ``decode`` (kv
    head counts) and the compressed cases on the ("pod", "data", "model")
    meshes of ``compressed`` (name -> shape) on one launch of 4 gloo
    processes that see no card (one start-up for them all): each case's
    :func:`gaps` with ``within``, :func:`decode_gaps`' result, by name
    (``decode kv <n>``), and each compressed mesh's rank-0
    :func:`compressed_rank` result with ``within`` (every rank's held)
    (``compressed <name>``)."""
    for kv in decode:
        (directory / f"decode_kv{kv}").mkdir(parents=True)
        decode_reference(directory / f"decode_kv{kv}", kv)
    body = "from torch_tp_case import decode_rank, train_rank\n"
    for name, (case, mesh, _) in train.items():
        (directory / name).mkdir(parents=True)
        body += f"train_rank(d + '/{name}', rank, {case!r}, 'bfloat16', {STEPS}, {mesh})\n"
    for kv in decode:
        body += f"decode_rank(d + '/decode_kv{kv}', rank, {kv})\n"
    if compressed:
        (directory / "compressed").mkdir(parents=True)
        body += (f"from torch_tp_case import compressed_rank\n"
                 f"compressed_rank(d + '/compressed', rank, {compressed!r})\n")
    with _no_card():
        run_ranks(body, 4, directory)
    out = {}
    for name, (case, _, held) in train.items():
        g = gaps([np.load(directory / name / f"out{r}.npz") for r in range(4)], case)
        out[name] = dict(g, within=within(g, "bfloat16", held))
    for kv in decode:
        out[f"decode kv {kv}"] = decode_result(directory / f"decode_kv{kv}")
    ranks = [json.loads((directory / "compressed" / f"compressed{r}.json").read_text())
             for r in range(4)] if compressed else []
    for name in compressed or {}:
        out[f"compressed {name}"] = dict(ranks[0][name], within=all(
            compressed_within(r[name]) for r in ranks))
    return out


def family_case(arch, changes: dict, prompt: int, batch: int = 4, seed: int = 0) -> tuple:
    """(model, params, batch dict) of a reduced config (``TINY`` where
    ``arch`` is None) with ``changes``: params from ``seed`` and a prompt of
    ``prompt`` tokens (and the VLM's vision embeddings) from a generator."""
    cfg = PC.ModelConfig(**TINY) if arch is None else PC.reduced_config(PC.ARCHS[arch])
    model = build_model(dataclasses.replace(cfg, **changes))
    cfg = model.cfg
    g = torch.Generator().manual_seed(seed)
    out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, prompt), generator=g)}
    if cfg.family == "encdec":
        out["frames"] = torch.randn((batch, prompt, cfg.d_model), generator=g)
    if cfg.family == "vlm":
        out["vision"] = torch.randn((batch, cfg.vision_tokens, cfg.d_model), generator=g)
    return model, model.init(seed, device="cpu"), out


def empty_piece_inputs() -> tuple:
    """float32 q [2, 1, 4, 16], k and v [2, 16, 2, 16] from a seed, and an
    additive mask [2, 1, 1, 16] that keeps slots 0-4 only: split in two,
    the second piece has no key left."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 1, 4, 16), (2, 16, 2, 16), (2, 16, 2, 16)))
    mask = torch.where(torch.arange(16) < 5, 0.0, -1e30).expand(2, 1, 1, 16)
    return q, k, v, mask


def decode_inputs(kv: int, directory) -> tuple:
    """(model, params, prompt [8, PROMPT], forced tokens or None) of the
    decode case: params from ``params.npz`` in ``directory`` where it is
    there (the reference's), else :func:`setup`'s; the tokens to feed from
    ``forced.npy`` where it is there."""
    from repro_torch.training._tree import unflatten

    model, params, batches = setup(kv)
    d = pathlib.Path(directory)
    if (d / "params.npz").exists():
        given = np.load(d / "params.npz")
        params = unflatten(params, [torch.from_numpy(given[f"arr_{i}"])
                                    for i in range(len(given.files))])
    forced = torch.from_numpy(np.load(d / "forced.npy")) if (d / "forced.npy").exists() else None
    return model, params, batches[0]["tokens"][:, :PROMPT], forced


def save_chain(path, chain) -> None:
    """:func:`decode_chain`'s result as float32 (positions int32) arrays."""
    logits, pref, outs, fed, caches = chain

    def arr(t):
        return t.numpy() if t.dtype == torch.int32 else t.float().numpy()

    np.savez(path, logits=arr(logits), fed=fed.numpy(),
             **{f"p{i}": arr(t) for i, t in enumerate(pref)},
             **{f"s{i}": arr(t) for i, t in enumerate(outs)},
             **{f"c{i}": arr(t) for i, t in enumerate(caches)})


def decode_rank(d, rank: int, kv: int) -> None:
    """One rank's part of the decode case: its prefill and DECODE_STEPS
    sharded decode steps on a 2 x 2 mesh, fed ``forced.npy`` in ``d``,
    saved made whole to ``d/dec<rank>.npz`` with the merges it made."""
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)  # the ranks share the host's cores
    model, params, prompt, forced = decode_inputs(kv, d)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    with counting(L, "merge_partials") as merges:
        chain = decode_chain(model, params, make_prefill_step(model, mesh),
                             make_decode_step(model, mesh), prompt, forced)
    save_chain(f"{d}/dec{rank}.npz", chain)
    np.save(f"{d}/merges{rank}.npy", np.array(len(merges)))


@contextlib.contextmanager
def recording_heads():
    """Yields the list of query-head counts of this rank's tile, one a call
    of ``head_range`` by the layers (an attention layer's call on a sharded
    step)."""
    seen, fn = [], L.head_range

    def recorded(n_heads, sh):
        out = fn(n_heads, sh)
        seen.append(out[1])
        return out

    L.head_range = recorded
    try:
        yield seen
    finally:
        L.head_range = fn


def heads_rank(d, rank: int, case: str, mesh: tuple) -> None:
    """One rank's part of an uneven-heads case (:data:`HEADS_CASES`), in
    bfloat16 and in float32 compute, each into ``d/<dtype>``: the train
    case (:func:`train_rank`: 3 sharded steps and a prefill), then the
    decode case's chain (a prefill of ``PROMPT`` tokens, ``DECODE_STEPS``
    sharded decode steps over buffers of ``DECODE_LEN`` split by sequence
    over ``"model"``, fed ``forced.npy``) saved as ``dec<rank>.npz``, with
    the query-head counts that this rank computed, its train case's flash
    calls and its decode's merges in ``heads<rank>.json``."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.kernels import ops

    for dtype in ("bfloat16", "float32"):
        out = f"{d}/{dtype}"
        with recording_heads() as train_heads, counting(ops, "flash_attention") as flash:
            train_rank(out, rank, case, dtype, STEPS, mesh)
        grid = init_device_mesh("cpu", mesh, mesh_dim_names=("data", "model"))
        model, params, prompt, forced = decode_inputs(case, out)
        with compute_in(dtype), recording_heads() as decode_heads, \
                counting(L, "merge_partials") as merges:
            chain = decode_chain(model, params, make_prefill_step(model, grid),
                                 make_decode_step(model, grid), prompt, forced)
        save_chain(f"{out}/dec{rank}.npz", chain)
        pathlib.Path(f"{out}/heads{rank}.json").write_text(json.dumps(
            {"train": sorted(set(train_heads)), "decode": sorted(set(decode_heads)),
             "calls": len(train_heads), "flash": len(flash), "merges": len(merges)}))


# the decode worker (run_ranks' body): the decode case
DECODE_WORKER = """
    from torch_tp_case import decode_rank
    decode_rank(d, rank, {kv})
"""


@contextlib.contextmanager
def counting(module, name: str):
    """``module.name`` wrapped to append 1 to the yielded list a call."""
    calls, fn = [], getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(1)
        return fn(*args, **kwargs)

    setattr(module, name, counted)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def state_gathers():
    """Yields [decode calls of the RG-LRU and RWKV6 blocks, all_gathers
    they made, all_gathers of a tensor of their states' shape and dtype]:
    ``models.transformer``'s ``rglru_apply`` and ``rwkv_apply`` wrapped to
    record, while a decode step's block runs, every input of
    ``torch.distributed.all_gather_into_tensor`` against its state's
    tensors (``h`` and ``conv``, or ``wkv``)."""
    import torch.distributed as dist

    counts = [0, 0, 0]
    saved = {n: getattr(T, n) for n in ("rglru_apply", "rwkv_apply")}
    gather = dist.all_gather_into_tensor

    def wrap(fn, fields):
        def wrapped(*args, state=None, **kwargs):
            if kwargs.get("mode") != "decode":
                return fn(*args, state=state, **kwargs)
            held = {(tuple(getattr(state, f).shape), getattr(state, f).dtype) for f in fields}

            def recorded(out, x, *a, **k):
                counts[1] += 1
                counts[2] += (tuple(x.shape), x.dtype) in held
                return gather(out, x, *a, **k)

            counts[0] += 1
            dist.all_gather_into_tensor = recorded
            try:
                return fn(*args, state=state, **kwargs)
            finally:
                dist.all_gather_into_tensor = gather
        return wrapped

    T.rglru_apply = wrap(saved["rglru_apply"], ("h", "conv"))
    T.rwkv_apply = wrap(saved["rwkv_apply"], ("wkv",))
    try:
        yield counts
    finally:
        for n, fn in saved.items():
            setattr(T, n, fn)


def chain_gaps(got, want) -> dict:
    """Two saved chains (``np.load`` of :func:`save_chain`'s files) against
    each other: the largest |difference| of the prefill's and every step's
    logits and of the caches, the largest of each over the largest |value|
    of its tensor (``logits_rel``, ``caches_rel``), whether each keeps
    LOGIT_TOL / CACHE_TOL, and whether the same tokens were fed."""
    def diff(keys):
        return max(float(np.abs(got[k].astype(np.float64) - want[k]).max()) for k in keys)

    steps = [k for k in want.files if k[0] == "s"]
    caches = [k for k in want.files if k[0] in "pc"]
    rel = max((float(np.abs(got[k].astype(np.float64) - want[k]).max()
                     / (np.abs(want[k]).max() or 1.0)) for k in caches), default=0.0)
    lrel = max(float(np.abs(got[k].astype(np.float64) - want[k]).max() / np.abs(want[k]).max())
               for k in ["logits"] + steps)
    return {"logits_max_abs": diff(["logits"] + steps), "caches_max_abs": diff(caches),
            "caches_rel": rel, "logits_rel": lrel,
            "same_tokens": bool(np.array_equal(got["fed"], want["fed"])),
            "logits_within": all(np.allclose(got[k], want[k], **LOGIT_TOL)
                                 for k in ["logits"] + steps),
            "caches_within": all(np.allclose(got[k], want[k], **CACHE_TOL) for k in caches)}


def decode_reference(directory: pathlib.Path, kv: int) -> None:
    """One device's chain of the decode case (greedy, unless ``forced.npy``
    in ``directory`` gives the tokens), saved as ``one.npz`` with the tokens
    it fed as ``forced.npy`` (which the ranks then feed: a greedy step's
    near tie would otherwise part the chains for good)."""
    model, params, prompt, forced = decode_inputs(kv, directory)
    chain = decode_chain(model, params, make_prefill_step(model, None),
                         make_decode_step(model, None), prompt, forced)
    save_chain(directory / "one.npz", chain)
    np.save(directory / "forced.npy", chain[3].numpy())


def decode_result(directory: pathlib.Path) -> dict:
    """Each rank's saved chain (:func:`decode_rank`) against one device's:
    :func:`chain_gaps` of the worst rank, whether every rank saved the same
    arrays, the merges each rank made, and ``within``."""
    want = np.load(directory / "one.npz")
    outs = [np.load(directory / f"dec{r}.npz") for r in range(4)]
    per = [chain_gaps(o, want) for o in outs]
    g = {k: max(p[k] for p in per) for k in ("logits_max_abs", "caches_max_abs")}
    g.update({k: all(p[k] for p in per) for k in ("same_tokens", "logits_within",
                                                  "caches_within")})
    g["same_on_every_rank"] = all(np.array_equal(o[k], outs[0][k]) for o in outs
                                  for k in outs[0].files)
    # one merge a layer a step: every decode step ran on split caches
    g["merges"] = [int(np.load(directory / f"merges{r}.npy")) for r in range(4)]
    g["within"] = (g["logits_within"] and g["caches_within"] and g["same_on_every_rank"]
                   and g["merges"] == [TINY["n_layers"] * DECODE_STEPS] * 4)
    return g


def decode_gaps(directory: pathlib.Path, kv: int) -> dict:
    """:func:`decode_reference`, then :data:`DECODE_WORKER` on 4 gloo ranks
    that see no card, fed the same tokens, then :func:`decode_result`."""
    decode_reference(directory, kv)
    with _no_card():
        run_ranks(DECODE_WORKER.format(kv=kv), 4, directory)
    return decode_result(directory)


# the (1, 2) worker: every MODEL_CASES chain in each of CHAIN_DTYPES, fed
# forced_<case><tag>.npy, with its merges and state gathers counted in
# bfloat16, then the merge of empty_piece_inputs over the two ranks
MODEL_WORKER = """
    torch.set_num_threads(1)  # the ranks share the host's cores
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.models import layers as L
    from repro_torch.training import make_decode_step, make_prefill_step
    from torch_tp_case import (CHAIN_DTYPES, MODEL_CASES, compute_in, counting, decode_chain,
                               empty_piece_inputs, family_case, save_chain, state_gathers)
    mesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
    for dtype, tag in CHAIN_DTYPES.items():
        for name, (arch, changes, prompt, length, steps) in MODEL_CASES.items():
            forced = torch.from_numpy(np.load(f"{d}/forced_{name}{tag}.npy"))
            with compute_in(dtype), counting(L, "merge_partials") as merges, \\
                    state_gathers() as gathers:
                model, params, batch = family_case(arch, changes, prompt)
                chain = decode_chain(model, params, make_prefill_step(model, mesh),
                                     make_decode_step(model, mesh), batch, forced, steps, length)
            save_chain(f"{d}/{name}{rank}{tag}.npz", chain)
            if not tag:
                np.save(f"{d}/{name}_merges{rank}.npy", np.array(len(merges)))
                np.save(f"{d}/{name}_gathers{rank}.npy", np.array(gathers))
    q, k, v, mask = empty_piece_inputs()
    mine = slice(rank * 8, rank * 8 + 8)
    y = L.merge_partials(*L._sdpa_partials(q, k[:, mine], v[:, mine], mask[..., mine]),
                         mesh.get_group("model"), torch.float32)
    np.save(f"{d}/empty{rank}.npy", y.numpy())
"""


# ------------------------------------------------- the sharded compressed step
# (tests/test_torch_crosspod.py, chip_smoke.py's phase 16 (c)): TINY with 2 kv
# heads on ("pod", "data", "model") meshes of 4 gloo ranks; the exchange takes
# every leaf of at least 64 elements through its blocks (TINY's norms of 128
# are one block; the default, 65,536, would send them all plain)
COMPRESSED_MESHES = {"pod2_data2": (2, 2, 1), "pod2_model2": (2, 1, 2), "pod4": (4, 1, 1)}
COMPRESS = dict(min_leaf_size=64)
# extra leaves for the exchange alone: (shape, spec) a leaf of 4 blocks split
# by rows over "data", one of 2 blocks (a pod's 2 ranks would each take one:
# c is held at 2 so that the fit keeps its many-row order) split over
# "model", and one split over both on dim 0
# the sharded compressed step against the whole-params one (bfloat16): each
# step's grad norm (steps 2-3 looser than TINY's 2e-3: a split contraction's
# rounding moves a block's int8 residuals by whole steps; measured 1.03e-3 on
# (2, 2, 1) and 4.1e-3 on (2, 1, 2) at step 3), the rest TINY's; float32
# compute holds losses and grad norms within 1e-5 (measured at most 6.9e-7)
COMPRESSED_GNORM_REL = (1e-3, 2e-3, 6e-3)
EXCHANGE_LEAVES = {"rows": ((4, 200), ("data", None)), "pair": ((2, 256), (None, "model")),
                   "both": ((16, 40), (("data", "model"), None))}


def whole_params_compressed_step(model, mesh, opt_cfg, comp_cfg):
    """The compressed step on whole params (every rank of a pod computes
    the pod's slice of the global batch, no rules), its gradient through
    ``compressed_psum_tree`` over the pod group: the oracle of the sharded
    step, written out."""
    import torch.distributed as dist

    from repro_torch.parallel.sharding import axis_rules
    from repro_torch.training.grad_compress import compressed_psum_tree

    group = mesh.get_group(comp_cfg.axis)
    n, rank = dist.get_world_size(group), dist.get_rank(group)

    def step(params, opt_state, ef, batch):
        b = batch["tokens"].shape[0] // n
        local = {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}
        with axis_rules(None):
            loss, parts, grads = TS._value_and_grad(model, params, local)
        grads, ef = compressed_psum_tree(grads, ef, comp_cfg, group=group)
        params, opt_state, gnorm = TS._update(opt_cfg, params, opt_state, grads)
        metrics = {"loss": loss, "grad_norm": gnorm, **parts}
        vals = torch.stack([metrics[k].to(torch.float32) for k in metrics])
        dist.all_reduce(vals, group=group)
        vals = torch.div(vals, torch.tensor(float(n)))
        return params, opt_state, ef, dict(zip(metrics, vals.unbind()))

    return step


def _exchange_case(model, params, mesh, bits: int) -> dict:
    """Seeded gradients and error feedback (each pod its own) of TINY's
    leaves and :data:`EXCHANGE_LEAVES`: ``compressed_psum_shards`` on this
    rank's shards against ``compressed_psum_tree`` on the whole leaves over
    the pod group, each mean and error feedback piece bit for bit."""
    from repro_torch.parallel.collectives import step_specs
    from repro_torch.parallel.sharding import P, local_shard, spec_placements
    from repro_torch.training import grad_compress as GC

    pod = mesh.get_coordinate()[0]
    rng = np.random.default_rng(100 + pod)
    shapes = [tuple(p.shape) for p in leaves(params)]
    specs = leaves(step_specs(params, model.cfg, mesh))
    for shape, spec in EXCHANGE_LEAVES.values():
        shapes.append(shape)
        specs.append(P(*spec))
    g = [torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.01) for s in shapes]
    e = [torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 1e-4) for s in shapes]
    cfg = GC.GradCompressConfig(bits=bits, **COMPRESS)
    group = mesh.get_group("pod")
    want, want_e = GC.compressed_psum_tree(g, e, cfg, group=group)
    piece = lambda t, s: local_shard(t, mesh, spec_placements(mesh, s))  # noqa: E731
    got, got_e = GC.compressed_psum_shards([piece(t, s) for t, s in zip(g, specs)],
                                           [piece(t, s) for t, s in zip(e, specs)], shapes,
                                           specs, cfg, GC.PodBlocks(mesh, "pod"), group=group)
    equal = [torch.equal(a, piece(b, s)) and torch.equal(x, piece(y, s))
             for a, b, x, y, s in zip(got, want, got_e, want_e, specs)]
    return {"leaves": len(equal), "equal": sum(equal),
            "blocks": sum(-(-int(np.prod(s)) // cfg.block) for s in shapes
                          if np.prod(s) >= cfg.min_leaf_size)}


def compressed_rank(d, rank: int, meshes: dict = COMPRESSED_MESHES,
                    dtypes: tuple = ("bfloat16",)) -> None:
    """One rank's part of the compressed cases: on each ("pod", "data",
    "model") mesh of ``meshes``, the exchange on shards against whole leaves
    (8 and 4 bits), then STEPS sharded compressed steps of TINY (2 kv
    heads) from params placed by ``param_shardings`` against the
    whole-params oracle from the same params: the rows and loss of each
    rank's first step, the gaps after the steps (``gaps``' measures) and
    whether every leaf and metric is bit-equal.  Saves
    ``d/compressed<rank>.json``."""
    from torch.distributed.device_mesh import init_device_mesh

    from torch_dist_helpers import placed_as_specs, whole
    from repro_torch.parallel import param_shardings
    from repro_torch.parallel.sharding import place
    from repro_torch.training import grad_compress as GC
    from repro_torch.training._tree import tree_map

    torch.set_num_threads(1)  # the ranks share the host's cores
    model, params, batches = setup(2)
    comp, opt_cfg = GC.GradCompressConfig(**COMPRESS), AdamWConfig(**OPT)
    out = {}
    for (name, shape), dtype in ((m, t) for m in meshes.items() for t in dtypes):
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("pod", "data", "model"))
        res = {f"exchange_bits{b}": _exchange_case(model, params, mesh, b) for b in (8, 4)}
        cm = compute_in(dtype)
        cm.__enter__()
        placed = tree_map(lambda p, s: place(p, *s), params,
                          param_shardings(params, model.cfg, mesh))
        seen, vg = [], TS._value_and_grad

        def recorded(m, p, batch):
            loss, parts, grads = vg(m, p, batch)
            seen.append((batch["tokens"].clone(), loss))
            return loss, parts, grads

        TS._value_and_grad = recorded
        try:
            step = TS.make_compressed_train_step(model, mesh, opt_cfg, comp)
            p, o, ef, got_m = placed, adamw_init(placed), TS.make_ef_state(placed), []
            for b in batches:
                p, o, ef, m = step(p, o, ef, b)
                got_m.append({k: float(v) for k, v in m.items()})
            rows, loss = seen[0]
            seen.clear()
            oracle = whole_params_compressed_step(model, mesh, opt_cfg, comp)
            q, qo, qef, want_m = params, adamw_init(params), TS.make_ef_state(params), []
            for b in batches:
                q, qo, qef, m = oracle(q, qo, qef, b)
                want_m.append({k: float(v) for k, v in m.items()})
            coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
            n_rows = batches[0]["tokens"].shape[0] // (shape[0] * shape[1])
            first = (coord["pod"] * shape[1] + coord["data"]) * n_rows
            want_rows = batches[0]["tokens"][first:first + n_rows]
            with torch.no_grad():  # one device on this rank's rows
                own_loss, _ = model.loss(params, {k: v[first:first + n_rows]
                                                  for k, v in batches[0].items()})
        finally:
            TS._value_and_grad = vg
            cm.__exit__(None, None, None)
        got_l, want_l = whole((p, o, ef)), leaves((q, qo, qef))
        res.update(
            rows_are_this_ranks=bool(torch.equal(rows, want_rows)),
            loss_of_its_rows_rel=abs(float(loss) - float(own_loss)) / float(own_loss),
            placed_as_specs=all(placed_as_specs(model, params, mesh, t) for t in (p, o["m"], ef)),
            bit_equal=all(torch.equal(a, b) for a, b in zip(got_l, want_l, strict=True))
            and got_m == want_m,
            param=max(float((a - b).abs().max() / b.abs().max()) for a, b in
                      zip(leaves(whole(p)), leaves(q))),
            moved=max(float((a - b).abs().mean() / (b - p0).abs().mean()) for a, b, p0 in
                      zip(leaves(whole(p)), leaves(q), leaves(params))),
            loss_rel=[abs(a["loss"] - b["loss"]) / b["loss"] for a, b in zip(got_m, want_m)],
            gnorm_rel=[abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
                       for a, b in zip(got_m, want_m)])
        out[name + ("" if dtype == "bfloat16" else "_" + dtype)] = res
    (pathlib.Path(d) / f"compressed{rank}.json").write_text(json.dumps(out))


def compressed_within(res: dict, dtype: str = "bfloat16") -> bool:
    """Whether a mesh's :func:`compressed_rank` result keeps the bounds:
    the exchange bit-equal on every leaf, each rank's first step on its own
    rows, the state placed by the specs, and the steps within TINY's
    bounds (grad norms :data:`COMPRESSED_GNORM_REL`; float32: losses and
    grad norms within 1e-5) of the whole-params step."""
    gnorm = COMPRESSED_GNORM_REL if dtype == "bfloat16" else (1e-5,) * STEPS
    loss = LOSS_REL if dtype == "bfloat16" else 1e-5
    return (all(e["equal"] == e["leaves"] for k, e in res.items() if k.startswith("exchange"))
            and res["rows_are_this_ranks"] and res["placed_as_specs"]
            and res["param"] <= GRAD_REL and res["moved"] <= MOVED_REL
            and all(x <= loss for x in res["loss_rel"])
            and all(x <= y for x, y in zip(res["gnorm_rel"], gnorm, strict=True)))


COMPRESSED_WORKER = """
    from torch_tp_case import compressed_rank
    compressed_rank(d, rank, dtypes=("bfloat16", "float32"))
"""
