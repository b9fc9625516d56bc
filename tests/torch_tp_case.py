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
prefill of this data rank's 4 rows, in the model's compute dtype
(bfloat16) or in float32 (:func:`compute_in`), and saves the whole state,
the first step's mean gradient, the metrics, the prefill's logits and
caches and this rank's local shard shapes; :func:`gaps` holds them
against the one-device step in the same compute dtype.

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
from repro_torch.training import AdamWConfig, adamw_init, make_prefill_step, make_train_step
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


def cache_leaves(caches) -> list:
    """The tensors of a prefill's stacked caches (dicts of cache
    dataclasses), in order."""
    return [getattr(c, f.name) for k in sorted(caches["groups"])
            for c in caches["groups"][k].values() for f in dataclasses.fields(c)]


def leaf_names(tree, path=()) -> list:
    """The dotted key paths of ``tree``'s leaves, in its leaf order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [n for i, t in enumerate(tree) for n in leaf_names(t, path + (str(i),))]
    return [".".join(path)]


# the worker (torch_dist_helpers.run_ranks' body): params from params.npz
# where given (else setup's), {steps} sharded steps on a 2 x 2 mesh, then a
# prefill of this data rank's rows, in {dtype} compute
WORKER = """
    import json, os
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.training import AdamWConfig, make_prefill_step, make_train_step
    from repro_torch.training import train_step as TS
    from repro_torch.training._tree import leaves, unflatten
    from torch_dist_helpers import recording_update, whole, whole_grads
    from torch_tp_case import OPT, cache_leaves, compute_in, leaf_names, run, setup
    model, params, batches = setup({kv})
    if os.path.exists(f"{{d}}/params.npz"):
        given = np.load(f"{{d}}/params.npz")
        params = unflatten(params, [torch.from_numpy(given[f"arr_{{i}}"])
                                    for i in range(len(given.files))])
    seen = []
    TS._update = recording_update(seen)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    rows = batches[0]["tokens"].shape[0] // 2
    mine = batches[0]["tokens"][mesh.get_coordinate()[0] * rows:][:rows]
    with compute_in("{dtype}"):
        p, opt, metrics = run(make_train_step(model, mesh, AdamWConfig(**OPT)), params,
                              batches[:{steps}])
        with torch.no_grad():
            logits, caches = make_prefill_step(model, mesh)(params, {{"tokens": mine}})
    grads = whole_grads(model, params, mesh, seen[0])
    shapes = {{n: list(t.to_local().shape) for n, t in zip(leaf_names(params), leaves(p))}}
    np.savez(f"{{d}}/out{{rank}}.npz", *[t.numpy() for t in whole((p, opt))],
             **{{f"g{{i}}": g.numpy() for i, g in enumerate(grads)}},
             **{{f"c{{i}}": t.float().numpy() for i, t in enumerate(cache_leaves(caches))}},
             logits=logits.float().numpy(), shapes=np.array(json.dumps(shapes)),
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
    whether each data rank's prefill is within LOGIT_TOL and CACHE_TOL."""
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
    prefill = True
    for r, o in enumerate(outs):  # each data rank's prefill against one device's
        rows = batches[0]["tokens"][(r // 2) * 4:][:4]
        with torch.no_grad(), compute_in(dtype):
            logits, caches = make_prefill_step(model, None)(params, {"tokens": rows})
        prefill &= bool(np.allclose(o["logits"], logits.float().numpy(), **LOGIT_TOL))
        prefill &= all(np.allclose(o[f"c{i}"], c.float().numpy(), **CACHE_TOL)
                       for i, c in enumerate(cache_leaves(caches)))
    out["prefill_within"] = prefill
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
