"""Train and serve steps, counterpart of ``repro.training.train_step``.

* ``make_train_step``: the loss's gradient on the params, clipped by the
  global norm, then AdamW.  ``mesh`` None: one device.  A DeviceMesh: the
  reference's jitted step with ``param_specs`` shardings, written out.
  Every param, its gradient and both AdamW moments are this rank's shard
  under the param's spec (``parallel.collectives.Shards``): the step takes
  DTensors placed by ``param_shardings`` (or plain tensors that every rank
  holds whole, and takes its pieces of them) and returns DTensors of the
  same placements.  Each rank trains on its slice of dim 0 of the global
  batch over the batch axes (``("pod", "data")``, as the reference's rules
  map ``batch``).  Each block gathers its leaves over the axes its compute
  does not split, inside its remat (ZeRO-3), and the gathers' backward
  reduce-scatters the gradients; a leaf replicated along a batch axis has
  its gradient summed over it in one flat float32 all_reduce (the metrics
  ride with the leaves replicated along every batch axis), and every
  gradient and metric is then the batch ranks' mean.  Every family splits
  heads, width, ffn and vocab over ``"model"`` as the rules map them
  (``_step_rules``; ``models.layers``, ``models.transformer``,
  ``models.model``): attention's and MLA's heads, the RG-LRU's channels,
  RWKV6's heads and channel-mix, cross-attention, the encoder, the MLP
  and the MoE's shared experts; a dim that the axis does not divide stays
  whole, and its leaves are gathered over ``"model"``.  A ``moe_ep``
  config whose experts the ``"model"`` axis divides trains them expert
  parallel, as the reference does (``models.layers._moe_apply_ep``): each
  rank holds, gathers over its fsdp axes and trains its own experts.  The clip's norm
  sums each shard once over the mesh (one all_reduce), and AdamW is
  elementwise on the shards, so a one-rank mesh gives the one-device
  step's bits.  What depends on the
  params' specs alone (the specs, placements, gather plans and the mean's
  buckets) is worked out on the first call and kept; later calls repeat
  only the collectives and the DTensors' wrapping.
* ``make_compressed_train_step``: each pod takes its slice of the global
  batch and computes its gradient as the sharded train step does inside
  the pod (``param_specs`` shards, ``"data"`` for the batch, TP over
  ``"model"``), and the cross-pod mean rides the SHRINK compressed
  exchange on whole blocks of each leaf (``grad_compress.py``), with error
  feedback carried in the step state, placed like the params.  ``mesh`` is
  a ``torch.distributed.device_mesh.DeviceMesh`` with a ``"pod"``
  dimension.
* ``make_prefill_step`` / ``make_decode_step`` on a mesh take the params
  as the train step does (shards) and the **global** batch, as the train
  step does: each slices dim 0 of every batch leaf (``_DataParallel.slice``;
  a dim the batch axes do not divide stays whole on every rank, as
  ``batch_specs`` replicates it).  Both run the train step's
  tensor-parallel layers (heads, width, ffn and vocab over ``"model"``;
  the split leaves are gathered only over their fsdp axes) and return
  DTensors of the
  global shapes: the logits as this rank's rows (``batch_specs``), the
  caches as this rank's pieces under ``cache_specs`` (batch over the batch
  axes, the sequence, or a recurrent state's width or heads, over
  ``"model"`` where it divides), so ``full_tensor()`` gives the
  reference's global arrays.  The prefill cuts its sequence caches to
  that layout (a recurrent or WKV state is this rank's piece as the split
  layer computes it, and decode reads and writes that piece);
  the decode takes caches so placed (DTensors, or whole plain tensors of
  which each rank takes its pieces), writes the step into its local
  pieces in place (the reference donates them) and attends over its piece
  of the sequence, the ranks' partial softmaxes merged over ``"model"``
  (``parallel.collectives.merge_partials``).  Where ``cache_specs`` leaves
  a sequence whole, or ``"model"`` is 1, that layer attends as one device
  does, so a one-rank mesh gives the one-device step's bits.  Under either
  an MoE config with ``moe_ep`` takes the expert-parallel route.

A step takes params as a tree of tensors and returns new trees (the
reference's ``(params, opt_state, metrics)``); the gradient is autograd's
on fresh leaves that require grad, so the caller's tensors never carry a
graph.  Metrics are 0-d float32 tensors: ``loss``, ``grad_norm``, ``xent``,
``z_loss`` and ``moe_aux``.  ``batch_specs``, ``cache_specs`` and
``train_state_specs`` are the reference's spec maps (``parallel.sharding.P``
trees).
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..configs.base import ModelConfig
from ..core.errors import ConfigError
from ..models import Model
from ..parallel.collectives import Shards
from ..parallel.partition import param_specs, spec_axes
from ..parallel.sharding import P, axis_rules, make_rules, mesh_axes, tree_map_with_path
from ._tree import leaves, tree_map, unflatten
from .grad_compress import GradCompressConfig, PodBlocks, _concat, _split, compressed_psum_shards
from .optimizer import AdamWConfig, adamw_update, clip_by_global_norm

__all__ = [
    "batch_specs",
    "cache_specs",
    "make_compressed_train_step",
    "make_decode_step",
    "make_ef_state",
    "make_prefill_step",
    "make_train_step",
    "train_state_specs",
]


# ---------------------------------------------------------------- spec maps
def _axes_size(mesh, batch_axes) -> int:
    shape = mesh_axes(mesh)
    return math.prod(shape[a] for a in (batch_axes if isinstance(batch_axes, tuple)
                                        else (batch_axes,)))


def batch_specs(batch_tree, mesh, batch_axes) -> Any:
    """Shard dim0 of every batch leaf over the batch axes (if divisible)."""
    size = _axes_size(mesh, batch_axes)

    def spec(leaf):
        b = leaf.shape[0] if leaf.ndim else 0
        if leaf.ndim == 0 or b % size:
            return P()
        return P(batch_axes, *([None] * (leaf.ndim - 1)))

    return tree_map(spec, batch_tree)


def cache_specs(cache_tree, mesh, batch_axes, seq_axis: str = "model") -> Any:
    """KV caches: batch over the data axes, the cache's sequence over the
    model axis (the flash-decoding layout: a card's cache memory is S/16,
    always divisible, unlike kv-head counts).  Recurrent states split their
    width or head dims over model."""
    bsz = _axes_size(mesh, batch_axes)
    msz = mesh_axes(mesh).get("model", 1)
    if isinstance(batch_axes, tuple) and len(batch_axes) == 1:
        batch_axes = batch_axes[0]

    def spec(path, leaf):
        name = next((k for k in reversed(path) if isinstance(k, str)), None)
        batch = batch_axes if (leaf.ndim and leaf.shape[0] % bsz == 0) else None
        b2 = batch_axes if (leaf.ndim > 1 and leaf.shape[1] % bsz == 0) else None

        def seq_ok(dim_size):
            return seq_axis if dim_size % msz == 0 else None

        def model_ok(dim_size):
            return "model" if dim_size % msz == 0 else None

        nd, sh = leaf.ndim, leaf.shape
        if name in ("k", "v") and nd == 4:  # [B, S, KV, D]
            return P(batch, seq_ok(sh[1]), None, None)
        if name in ("k", "v") and nd == 5:  # stacked [G, B, S, KV, D]
            return P(None, b2, seq_ok(sh[2]), None, None)
        if name == "kpos" and nd == 2:
            return P(batch, seq_ok(sh[1]))
        if name == "kpos" and nd == 3:
            return P(None, b2, seq_ok(sh[2]))
        if name in ("c_kv", "k_rope") and nd == 3:  # [B, S, R]
            return P(batch, seq_ok(sh[1]), None)
        if name in ("c_kv", "k_rope") and nd == 4:
            return P(None, b2, seq_ok(sh[2]), None)
        if name == "wkv" and nd == 4:  # [B, H, K, V]
            return P(batch, model_ok(sh[1]), None, None)
        if name == "wkv" and nd == 5:
            return P(None, b2, model_ok(sh[2]), None, None)
        if name == "h" and nd == 2:
            return P(batch, model_ok(sh[1]))
        if name == "h" and nd == 3:
            return P(None, b2, model_ok(sh[2]))
        if name == "conv" and nd == 3:
            return P(batch, None, model_ok(sh[2]))
        if name == "conv" and nd == 4:
            return P(None, b2, None, model_ok(sh[3]))
        if name in ("shift_t", "shift_c") and nd == 2:
            return P(batch, None)
        if name in ("shift_t", "shift_c") and nd == 3:
            return P(None, b2, None)
        return P(*([None] * nd))

    return tree_map_with_path(spec, cache_tree)


def train_state_specs(params_shapes, cfg: ModelConfig, mesh):
    ps = param_specs(params_shapes, cfg, mesh)
    return {
        "m": ps,
        "v": ps,
        "step": P(),
    }


# ------------------------------------------------------------- train steps
def _value_and_grad(model: Model, params, batch):
    """(loss, parts, grads): the gradient of ``model.loss`` on every param
    (zeros where the loss does not read one)."""
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, parts = model.loss(p, batch)
        flat = leaves(p)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(flat, grads)]
    return loss.detach(), {k: v.detach() for k, v in parts.items()}, unflatten(params, grads)


def _update(opt_cfg: AdamWConfig, params, opt_state, grads, norm=None):
    """Clip by the global norm (``norm(grads)`` where given: a sharded
    step's), then AdamW."""
    with torch.no_grad():
        grads, gnorm = clip_by_global_norm(grads, opt_cfg.grad_clip,
                                           None if norm is None else norm(grads))
        params, opt_state = adamw_update(opt_cfg, params, grads, opt_state)
    return params, opt_state, gnorm


def _plain(t):
    return t.to_local() if isinstance(t, DTensor) else t


class _DataParallel:
    """The batch axes of a DeviceMesh (``names``, default those of
    ``("pod", "data")`` that it has): this rank's index among the ranks
    that share its coordinates along the other axes (pod major), their
    count, each batch axis's group and the group of them all (the axis's
    own, or one made for the pod x data plane: every rank makes every
    plane's group, in one order).  No batch axis is one rank: a slice is
    the whole batch and a mean divides by 1."""

    def __init__(self, mesh, names=None):
        axes = mesh_axes(mesh)
        if names is None:
            names = tuple(a for a in ("pod", "data") if a in axes)
            if not names:
                raise ConfigError(f"data parallelism needs a 'data' or 'pod' axis; the mesh "
                                  f"has {tuple(axes)}")
        self.names = tuple(a for a in names if a in axes)
        coord = dict(zip(axes, mesh.get_coordinate()))
        self.n = math.prod(axes[a] for a in self.names)
        self._buckets: dict = {}
        self.rank = 0
        for a in self.names:
            self.rank = self.rank * axes[a] + coord[a]
        self.groups = {(a,): mesh.get_group(a) for a in self.names}
        if len(self.names) > 1:
            ranks = mesh.mesh.permute(*[list(axes).index(a) for a in self.names]
                                      + [i for i, a in enumerate(axes) if a not in self.names])
            planes = ranks.reshape(self.n, -1).T.tolist()
            mine = dist.get_rank()
            for plane in planes:  # every rank creates every group
                group = dist.new_group(plane)
                if mine in plane:
                    self.groups[self.names] = group

    def slice(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a batch leaf (the whole leaf where dim 0 does
        not divide, as ``batch_specs`` replicates it)."""
        if x.ndim == 0 or x.shape[0] % self.n:
            return x
        b = x.shape[0] // self.n
        return x[self.rank * b:(self.rank + 1) * b]

    def mean(self, grads: list, specs: list, metrics: list) -> tuple[list, list]:
        """The batch ranks' mean of each gradient and metric.  A gradient
        arrives summed over the batch axes its spec names (the gathers'
        reduce-scatter); the axes it is replicated along sum it here, in one
        flat float32 all_reduce a set of axes, the metrics with the set of
        them all."""
        out, n = list(grads) + list(metrics), len(grads)
        key = (tuple(specs), len(metrics))
        if key not in self._buckets:  # made once for the step's specs
            buckets: dict[tuple, list] = {self.names: list(range(n, len(out)))}
            for i, spec in enumerate(specs):
                named = set(spec_axes(spec))
                buckets.setdefault(tuple(a for a in self.names if a not in named), []).append(i)
            self._buckets[key] = buckets
        buckets = self._buckets[key]
        count = None
        for axes, idx in buckets.items():
            tensors = [out[i] for i in idx]
            if not tensors:
                continue
            buf, shapes = _concat(tensors)
            if axes:
                dist.all_reduce(buf, group=self.groups[axes])
            count = torch.tensor(float(self.n), device=buf.device) if count is None else count
            buf = torch.div(buf, count)
            for i, m, t in zip(idx, _split(buf, tensors, shapes), tensors):
                out[i] = m.to(t.dtype)
        return out[:n], out[n:]


def _mesh_group(mesh):
    """A process group over every rank of ``mesh``."""
    ranks = mesh.mesh.flatten().tolist()
    if len(ranks) == dist.get_world_size():
        return dist.group.WORLD
    return dist.new_group(sorted(ranks))


def _step_rules(mesh, cfg: ModelConfig, shards: Shards, overrides=None):
    """The rules of a sharded step: ``make_rules``' with this rank's
    ``shards``, and every family's heads, width, ffn and vocabulary split
    over ``"model"`` as they map there, except where the axis does not
    divide the dim, which then stays whole (each rank gathers its leaves
    whole over ``"model"`` and computes all of it):

    * ``heads`` and ``kv_heads``: query heads (RWKV's ``d_model //
      rwkv_head_dim``, as ``cache_specs`` splits its state) stay whole,
      their kv heads with them, unless ``cfg.force_head_sharding``: then
      ``heads`` maps to ``"model"`` as ``make_rules`` maps it, and each
      rank computes the heads of its GSPMD tile
      (``parallel.collectives.head_range``: llama4's 40 heads on 16 ranks,
      3 a rank and none on the last two), while ``kv_heads`` keeps
      ``make_rules``' divisibility (llama4's 8 kv heads stay whole).  The
      uneven split runs in the grouped-query attention (self, cross and
      the encoder's); MLA and RWKV6 heads that the axis does not divide
      raise ``ConfigError``;
    * ``ffn``: ``d_ff`` and the shared experts' width;
    * ``lru_width`` (the RG-LRU's channels; the reference shards its input
      branch on ``ffn``).

    The padded vocabulary maps to ``"model"`` as ``make_rules`` maps it; a
    vocabulary that the axis does not divide is refused by the step's
    placement (``parallel.collectives.step_specs``), as JAX's shardings
    refuse it.  Which leaf's dim carries which of these axes is
    ``parallel.partition.model_axis``'s table."""
    rules = make_rules(mesh, cfg, overrides)
    msize = mesh_axes(mesh).get("model", 1)

    def whole(*dims) -> bool:
        return any(n % msize for n in dims if n)

    heads = cfg.d_model // cfg.rwkv_head_dim if "rwkv" in cfg.block_group else cfg.n_heads
    if whole(heads):
        if not cfg.force_head_sharding:
            rules.mapping.update(heads=None, kv_heads=None)
        elif cfg.mla or "rwkv" in cfg.block_group:
            raise ConfigError(f"{cfg.name}: force_head_sharding splits {heads} heads over "
                              f"{msize} ranks unevenly in grouped-query attention only, "
                              f"not in MLA or RWKV6")
    if whole(cfg.d_ff, cfg.moe_d_ff * cfg.n_shared_experts):
        rules.mapping["ffn"] = None
    split = "model" in mesh_axes(mesh) and not whole(cfg.lru_width or cfg.d_model)
    rules.mapping["lru_width"] = "model" if split else None
    rules.shards = shards
    return rules


def _mesh_norm(sh: Shards, world, specs: list):
    """The clip's norm of gradients held as shards placed by ``specs``:
    each piece's squares summed once over the mesh (from 0, in leaf order,
    as ``global_norm`` sums them), one all_reduce over ``world``."""
    def norm(grads):
        flat = leaves(grads)
        sq = torch.zeros((), dtype=torch.float32, device=flat[0].device)
        for g, s in zip(flat, specs):
            if sh.counted(s):
                sq = sq + torch.sum(torch.square(g.to(torch.float32)))
        dist.all_reduce(sq, group=world)
        return torch.sqrt(sq)
    return norm


def _sharded_grads(model: Model, sh: Shards, dp: _DataParallel, rules, params, opt_state,
                   batch):
    """A sharded step's gradient: (the specs, this rank's shards of the
    params and AdamW state, the batch ranks' mean gradient of ``model.loss``
    on this rank's ``batch`` under ``rules``, and the metrics' mean)."""
    specs = sh.specs(params)
    local = sh.local(params, specs)
    opt = {"m": sh.local(opt_state["m"], specs), "v": sh.local(opt_state["v"], specs),
           "step": _plain(opt_state["step"])}
    with axis_rules(rules):
        loss, parts, grads = _value_and_grad(model, local, batch)
    metrics = {"loss": loss, **parts}
    got, vals = dp.mean(leaves(grads), leaves(specs), list(metrics.values()))
    return specs, local, opt, unflatten(grads, got), dict(zip(metrics, vals))


def _wrap_state(sh: Shards, specs, params, local, opt) -> tuple:
    """The new params and AdamW state as DTensors placed by ``specs``."""
    return sh.wrap(local, specs, params), {
        "m": sh.wrap(opt["m"], specs, params), "v": sh.wrap(opt["v"], specs, params),
        "step": opt["step"]}


def make_train_step(model: Model, mesh=None, opt_cfg: AdamWConfig = AdamWConfig()):
    if mesh is None:
        def one_device(params, opt_state, batch):
            with axis_rules(None):
                loss, parts, grads = _value_and_grad(model, params, batch)
            params, opt_state, gnorm = _update(opt_cfg, params, opt_state, grads)
            return params, opt_state, {"loss": loss, "grad_norm": gnorm, **parts}

        return one_device
    cfg = model.cfg
    sh, dp, world = Shards(mesh, cfg), _DataParallel(mesh), _mesh_group(mesh)
    rules = _step_rules(mesh, cfg, sh)

    def step(params, opt_state, batch):
        specs, local, opt, grads, metrics = _sharded_grads(
            model, sh, dp, rules, params, opt_state, {k: dp.slice(v) for k, v in batch.items()})
        local, opt, gnorm = _update(opt_cfg, local, opt, grads,
                                    norm=_mesh_norm(sh, world, leaves(specs)))
        metrics = {"loss": metrics.pop("loss"), "grad_norm": gnorm, **metrics}
        return (*_wrap_state(sh, specs, params, local, opt), metrics)

    return step


def make_compressed_train_step(
    model: Model,
    mesh,
    opt_cfg: AdamWConfig = AdamWConfig(),
    comp_cfg: GradCompressConfig = GradCompressConfig(),
):
    """Cross-pod SHRINK-compressed data parallelism: ``step(params,
    opt_state, ef, batch)`` with the global batch; each pod trains on its
    slice of dim 0 (the reference's ``P("pod")`` in-spec) and, inside the
    pod, as the sharded train step does under the reference's rules with
    ``batch`` on ``"data"``: each rank holds its ``param_specs`` shards
    (replicated over the pods), trains on its rows of the pod's slice, and
    splits heads, ffn and vocab over ``"model"``.  The pod's mean gradient
    then crosses the pods through the compressed exchange on whole blocks
    of each leaf (``grad_compress.compressed_psum_shards``: the bits that
    ``compressed_psum_tree`` gives the whole leaves), with the error
    feedback ``ef`` placed like the params; the metrics are the pods'
    mean.  A mesh of ``"pod"`` alone holds the params whole."""
    cfg = model.cfg
    if comp_cfg.axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"compressed step needs a {comp_cfg.axis!r} axis")
    if cfg.dcn_fsdp:
        raise ValueError("compressed collective targets pod-replicated params")
    group = mesh.get_group(comp_cfg.axis)
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)
    sh, dp, world = Shards(mesh, cfg), _DataParallel(mesh, ("data",)), _mesh_group(mesh)
    # inside a pod the batch rides "data" only (the reference's override)
    rules = _step_rules(mesh, cfg, sh, overrides={"batch": dp.names or None})
    blocks = PodBlocks(mesh, comp_cfg.axis)

    def pod_slice(x):
        b = x.shape[0] // n
        return x[rank * b:(rank + 1) * b]

    def step(params, opt_state, ef, batch):
        specs, local, opt, grads, metrics = _sharded_grads(
            model, sh, dp, rules, params, opt_state,
            {k: dp.slice(pod_slice(v)) for k, v in batch.items()})
        flat_specs = leaves(specs)
        grads, new_ef = compressed_psum_shards(grads, sh.local(ef, specs),
                                               [p.shape for p in leaves(params)], flat_specs,
                                               comp_cfg, blocks, group=group)
        local, opt, gnorm = _update(opt_cfg, local, opt, grads,
                                    norm=_mesh_norm(sh, world, flat_specs))
        # every metric is the pods' mean, as the reference's psum / n
        metrics = {"loss": metrics.pop("loss"), "grad_norm": gnorm, **metrics}
        vals = torch.stack([metrics[k].to(torch.float32) for k in metrics])
        if n > 1:
            dist.all_reduce(vals, group=group)
        vals = torch.div(vals, torch.tensor(float(n), device=vals.device))
        return (*_wrap_state(sh, specs, params, local, opt), sh.wrap(new_ef, specs, params),
                dict(zip(metrics, vals.unbind())))

    return step


def make_ef_state(params):
    """Zero error feedback in float32, a leaf of each param's global shape
    (a DTensor placed as the param is where it is one)."""
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


# ------------------------------------------------------------- serve steps
class _Global:
    """A leaf's global shape, all that ``batch_specs``, ``cache_specs`` and
    ``Shards.wrap`` read of it (no tensor: a step's cost counter would count
    a meta tensor's bytes)."""

    __slots__ = ("shape",)

    def __init__(self, shape):
        self.shape = tuple(shape)

    @property
    def ndim(self) -> int:
        return len(self.shape)


def _rows(sh: Shards, dp: _DataParallel, x: torch.Tensor, rows: int) -> DTensor:
    """``x``, this rank's slice of dim 0 of a global batch of ``rows``, as a
    DTensor of the global shape placed by ``batch_specs`` (replicated where
    the batch axes do not divide ``rows``)."""
    like = _Global((rows, *x.shape[1:]))
    return sh.wrap(x, batch_specs(like, sh.mesh, dp.names), like)


# the decode states that the layers compute on this rank's piece of their
# width or heads where the rules split them: name -> (dim, logical axis)
_SPLIT_STATES = {"h": (-1, "lru_width"), "conv": (-1, "lru_width"), "wkv": (-3, "heads")}


def _split_state(path, rules) -> bool:
    name = path[-1]
    return name in _SPLIT_STATES and rules.resolve(_SPLIT_STATES[name][1]) == "model"


def _global_caches(caches, rows: int, rules, n: int):
    """The global shapes of a prefill's caches, computed from this rank's
    slice of a global batch of ``rows``: each leaf's with its batch dim
    (dim 1 of the stacked groups', dim 0 of the others) at ``rows``, and a
    state that the layers split over ``"model"`` (``_SPLIT_STATES``) at
    ``n`` times its piece."""
    def one(path, t):
        shape = list(t.shape)
        shape[1 if path[0] == "groups" else 0] = rows
        if _split_state(path, rules):
            shape[_SPLIT_STATES[path[-1]][0]] *= n
        return _Global(shape)

    return tree_map_with_path(one, caches)


def make_prefill_step(model: Model, mesh=None):
    if mesh is None:
        def one_device(params, batch):
            with axis_rules(None):
                return model.prefill(params, batch)

        return one_device
    sh, dp = Shards(mesh, model.cfg), _DataParallel(mesh)
    rules = _step_rules(mesh, model.cfg, sh)

    def step(params, batch):
        rows = batch["tokens"].shape[0]
        with axis_rules(rules):
            logits, caches = model.prefill(sh.local(params, sh.specs(params)),
                                           {k: dp.slice(v) for k, v in batch.items()})
        like = _global_caches(caches, rows, rules, sh.sizes.get("model", 1))
        specs = cache_specs(like, mesh, dp.names)
        # the sequence caches are whole over "model" (cut here); the split
        # states are this rank's pieces already
        cuts = tree_map_with_path(lambda path, s: P(*[None] * len(s)) if _split_state(
            path, rules) else s, specs)
        return (_rows(sh, dp, logits, rows),
                sh.wrap(sh.cut(caches, cuts, ("model",)), specs, like))

    return step


def make_decode_step(model: Model, mesh=None):
    if mesh is None:
        def one_device(params, tokens, caches, cache_index):
            with axis_rules(None):
                return model.decode_step(params, tokens, caches, cache_index)

        return one_device
    sh, dp = Shards(mesh, model.cfg), _DataParallel(mesh)
    # the reference's decode rules: seq_model on "model" (its caches'
    # sequence), heads, ffn and vocab on "model" as in prefill
    rules = _step_rules(mesh, model.cfg, sh, overrides={"seq_model": "model"})

    def step(params, tokens, caches, cache_index):
        specs = cache_specs(caches, mesh, dp.names)
        local = sh.local(caches, specs)
        with axis_rules(rules):
            logits, local = model.decode_step(sh.local(params, sh.specs(params)),
                                              dp.slice(tokens), local, cache_index,
                                              pieces=sh.cache_pieces(caches, specs))
        return _rows(sh, dp, logits, tokens.shape[0]), sh.wrap(local, specs, caches)

    return step
