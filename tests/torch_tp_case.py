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
# self caches and its cross cache; none for RWKV's state, which is gathered,
# nor for a buffer of 15, which the axis does not divide)
MODEL_CASES = {
    "mla": ("deepseek-v2-lite-16b", {}, 6, 16, 4),  # slots 6 .. 9 over the boundary at 8
    "ring": ("recurrentgemma-9b", {}, 30, 40, 4),  # a ring of 32: slots 30, 31, then 0, 1
    "cross": ("llama-3.2-vision-11b", {}, 6, 16, 4),  # 16 vision tokens, 8 a rank
    "rwkv6": ("rwkv6-1.6b", {}, 6, 16, 4),  # 4 WKV heads, 2 a rank
    "masked": (None, {"masked_cache_update": True}, 6, 16, 4),
    "undivided": (None, {"n_kv_heads": 2}, 6, 15, 4),
}
MERGES_A_STEP = {"mla": 2, "ring": 1, "cross": 6, "rwkv6": 0, "masked": 2, "undivided": 0}


def setup(kv: int):
    model = build_model(PC.ModelConfig(**dict(TINY, n_kv_heads=kv)))
    params = model.init(0, device="cpu")
    pipe = TokenPipeline(vocab_size=TINY["vocab_size"], batch=8, seq_len=32, seed=5)
    batches = [{k: torch.from_numpy(v) for k, v in pipe.batch_at(s).items()}
               for s in range(STEPS)]
    return model, params, batches


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


# the worker (torch_dist_helpers.run_ranks' body): params from params.npz
# where given (else setup's), {steps} sharded steps on a 2 x 2 mesh, then a
# prefill of the global batch, in {dtype} compute
WORKER = """
    import json, os
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.training import AdamWConfig, make_prefill_step, make_train_step
    from repro_torch.training import train_step as TS
    from repro_torch.training._tree import leaves, unflatten
    from torch_dist_helpers import recording_update, whole, whole_grads
    from torch_tp_case import OPT, cache_tensors, compute_in, leaf_names, run, setup
    model, params, batches = setup({kv})
    if os.path.exists(f"{{d}}/params.npz"):
        given = np.load(f"{{d}}/params.npz")
        params = unflatten(params, [torch.from_numpy(given[f"arr_{{i}}"])
                                    for i in range(len(given.files))])
    seen = []
    TS._update = recording_update(seen)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    with compute_in("{dtype}"):
        p, opt, metrics = run(make_train_step(model, mesh, AdamWConfig(**OPT)), params,
                              batches[:{steps}])
        with torch.no_grad():
            logits, caches = make_prefill_step(model, mesh)(params,
                                                            {{"tokens": batches[0]["tokens"]}})
    grads = whole_grads(model, params, mesh, seen[0])
    shapes = {{n: list(t.to_local().shape) for n, t in zip(leaf_names(params), leaves(p))}}
    np.savez(f"{{d}}/out{{rank}}.npz", *[t.numpy() for t in whole((p, opt))],
             **{{f"g{{i}}": g.numpy() for i, g in enumerate(grads)}},
             **{{f"c{{i}}": t.float().numpy() for i, t in enumerate(cache_tensors(caches))}},
             logits=logits.full_tensor().float().numpy(), shapes=np.array(json.dumps(shapes)),
             loss=np.array([float(m["loss"]) for m in metrics]),
             gnorm=np.array([float(m["grad_norm"]) for m in metrics]))
"""


def run_workers(directory: pathlib.Path, kv: int, dtype: str = "bfloat16",
                steps: int = STEPS) -> list:
    """:data:`WORKER` on 4 gloo ranks; each rank's saved arrays."""
    run_ranks(WORKER.format(kv=kv, steps=steps, dtype=dtype), 4, directory)
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


def gaps(outs: list, kv: int, dtype: str = "bfloat16") -> dict:
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
        out["grad"] = max(out["grad"], float(np.abs(got[f"g{i}"] - g).max() / np.abs(g).max()))
    for i, (p0, w) in enumerate(zip(leaves(params), want)):
        a, moved = got[f"arr_{i}"], np.abs(w - p0.float().numpy()).mean()
        out["param"] = max(out["param"], float(np.abs(a - w).max() / np.abs(w).max()))
        out["moved"] = max(out["moved"], float(np.abs(a - w).mean() / moved) if moved else np.inf)
    loss = np.array([float(m["loss"]) for m in metrics])
    gnorm = np.array([float(m["grad_norm"]) for m in metrics])
    out["loss_rel"] = (np.abs(got["loss"] - loss) / loss).tolist()
    out["gnorm_rel"] = (np.abs(got["gnorm"] - gnorm) / gnorm).tolist()
    with torch.no_grad(), compute_in(dtype):  # every rank's prefill against one device's
        logits, caches = make_prefill_step(model, None)(params, {"tokens": batches[0]["tokens"]})
    out["prefill_within"] = all(
        np.allclose(o["logits"], logits.float().numpy(), **LOGIT_TOL)
        and all(np.allclose(o[f"c{i}"], c.float().numpy(), **CACHE_TOL)
                for i, c in enumerate(cache_tensors(caches))) for o in outs)
    out["local_shapes"] = {r: json.loads(str(o["shapes"])) for r, o in enumerate(outs)}
    return out


def within(g: dict, dtype: str = "bfloat16") -> bool:
    """Whether :func:`gaps`' ``g`` keeps every bound."""
    return (g["same_state"] and g["prefill_within"] and g["grad"] <= GRAD_REL
            and g["param"] <= GRAD_REL and g["moved"] <= MOVED_REL
            and all(x <= LOSS_REL for x in g["loss_rel"])
            and all(x <= b for x, b in zip(g["gnorm_rel"], GNORM_REL[dtype], strict=True)))


def check_in_subprocesses(directory: pathlib.Path, kv: int, dtype: str = "bfloat16") -> dict:
    """:func:`run_workers` then :func:`gaps`, with the gaps and ``within``;
    the workers see no card and take 2 threads each."""
    env = {k: os.environ.get(k) for k in ("CUDA_VISIBLE_DEVICES", "OMP_NUM_THREADS")}
    os.environ.update(CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    try:
        outs = run_workers(directory, kv, dtype)
    finally:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    g = gaps(outs, kv, dtype)
    return dict(g, within=within(g, dtype))


def family_case(arch, changes: dict, prompt: int, batch: int = 4, seed: int = 0) -> tuple:
    """(model, params, batch dict) of a reduced config (``TINY`` where
    ``arch`` is None) with ``changes``: params from ``seed`` and a prompt of
    ``prompt`` tokens (and the VLM's vision embeddings) from a generator."""
    cfg = PC.ModelConfig(**TINY) if arch is None else PC.reduced_config(PC.ARCHS[arch])
    model = build_model(dataclasses.replace(cfg, **changes))
    cfg = model.cfg
    g = torch.Generator().manual_seed(seed)
    out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, prompt), generator=g)}
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


# the decode worker: the decode case's prefill and DECODE_STEPS sharded
# decode steps on a 2 x 2 mesh, saved made whole
DECODE_WORKER = """
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.training import make_decode_step, make_prefill_step
    from repro_torch.models import layers as L
    from torch_tp_case import counting, decode_chain, decode_inputs, save_chain
    model, params, prompt, forced = decode_inputs({kv}, d)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    with counting(L, "merge_partials") as merges:
        chain = decode_chain(model, params, make_prefill_step(model, mesh),
                             make_decode_step(model, mesh), prompt, forced)
    save_chain(f"{{d}}/dec{{rank}}.npz", chain)
    np.save(f"{{d}}/merges{{rank}}.npy", np.array(len(merges)))
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


def chain_gaps(got, want) -> dict:
    """Two saved chains (``np.load`` of :func:`save_chain`'s files) against
    each other: the largest |difference| of the prefill's and every step's
    logits and of the caches, whether each keeps LOGIT_TOL / CACHE_TOL,
    and whether the same tokens were fed."""
    def diff(keys):
        return max(float(np.abs(got[k].astype(np.float64) - want[k]).max()) for k in keys)

    steps = [k for k in want.files if k[0] == "s"]
    caches = [k for k in want.files if k[0] in "pc"]
    return {"logits_max_abs": diff(["logits"] + steps), "caches_max_abs": diff(caches),
            "same_tokens": bool(np.array_equal(got["fed"], want["fed"])),
            "logits_within": all(np.allclose(got[k], want[k], **LOGIT_TOL)
                                 for k in ["logits"] + steps),
            "caches_within": all(np.allclose(got[k], want[k], **CACHE_TOL) for k in caches)}


def decode_gaps(directory: pathlib.Path, kv: int) -> dict:
    """One device's chain (greedy, unless ``forced.npy`` in ``directory``
    gives the tokens, which it then saves there), then :data:`DECODE_WORKER`
    on 4 gloo ranks fed the same tokens (the workers see no card and take
    2 threads each), each rank's chain against one device's:
    :func:`chain_gaps` of the worst rank, whether every rank saved the same
    arrays, and ``within``.  A greedy step's near tie would otherwise part
    the chains for good."""
    model, params, prompt, forced = decode_inputs(kv, directory)
    chain = decode_chain(model, params, make_prefill_step(model, None),
                         make_decode_step(model, None), prompt, forced)
    save_chain(directory / "one.npz", chain)
    np.save(directory / "forced.npy", chain[3].numpy())
    env = {k: os.environ.get(k) for k in ("CUDA_VISIBLE_DEVICES", "OMP_NUM_THREADS")}
    os.environ.update(CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    try:
        run_ranks(DECODE_WORKER.format(kv=kv), 4, directory)
    finally:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
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


# the (1, 2) worker: every MODEL_CASES chain fed forced_<case>.npy, with its
# merges counted, then the merge of empty_piece_inputs over the two ranks
MODEL_WORKER = """
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.models import layers as L
    from repro_torch.training import make_decode_step, make_prefill_step
    from torch_tp_case import (MODEL_CASES, counting, decode_chain, empty_piece_inputs,
                               family_case, save_chain)
    mesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
    for name, (arch, changes, prompt, length, steps) in MODEL_CASES.items():
        model, params, batch = family_case(arch, changes, prompt)
        forced = torch.from_numpy(np.load(f"{d}/forced_{name}.npy"))
        with counting(L, "merge_partials") as merges:
            chain = decode_chain(model, params, make_prefill_step(model, mesh),
                                 make_decode_step(model, mesh), batch, forced, steps, length)
        save_chain(f"{d}/{name}{rank}.npz", chain)
        np.save(f"{d}/{name}_merges{rank}.npy", np.array(len(merges)))
    q, k, v, mask = empty_piece_inputs()
    mine = slice(rank * 8, rank * 8 + 8)
    y = L.merge_partials(*L._sdpa_partials(q, k[:, mine], v[:, mine], mask[..., mine]),
                         mesh.get_group("model"), torch.float32)
    np.save(f"{d}/empty{rank}.npy", y.numpy())
"""
