"""SHRINK gradient compression for the cross-pod all-reduce, counterpart of
``repro.training.grad_compress``.

Each leaf of the gradient (plus its error feedback) is cut into blocks of
``block`` elements; each block's least-squares line (theta, slope, kept as
bf16) is its "semantics", and the residual is quantized to ``bits`` against
a step shared by all pods (the all-pod max of the block's max |r| over
qmax), with error feedback carried in the step state.  The wire carries
int8 residuals (4 bits packed two to a byte at ``bits <= 4``) and the bf16
bases; each pod sums what it gathers in pod order and dequantizes.

The fit is the ``base_fit`` kernel (``core.tensorshrink.linear_base_fit``,
the reference's summation order); the quantization is torch ops that
divide by a tensor (``r / step``, as the reference's ``jnp.round(r /
step)``; the ``residual_quant`` kernel multiplies by ``1 / step``, which
rounds some elements the other way), and the two dequantizations
``base + q * step`` round once, as the reference's jitted exchange
contracts them into fused multiply-adds.  The reference's ``pmax``,
``all_gather`` and ``psum`` over the ``"pod"`` axis of a ``shard_map`` are
``torch.distributed``'s ``all_reduce(MAX)``, ``all_gather_into_tensor``
and ``all_reduce(SUM)`` over the pod group (``group``: None is the
default group, or a world of one where ``torch.distributed`` is not
initialized).

``make_crosspod_exchange`` is the stand-alone exchange stage over a
DeviceMesh with a ``"pod"`` dimension: each rank exchanges its own shard
of every leaf (``parallel.sharding.shard_map_compat`` over the whole
mesh), plain (the float32 mean) or compressed, a leaf at a time or as one
flat bucket.

``compressed_psum_shards`` is ``compressed_psum_tree`` for a state whose
ranks hold ``param_specs`` shards inside each pod (the compressed train
step): the reference's exchange sees each leaf whole, so a leaf's shards
go to whole blocks of its flattening first (:class:`PodBlocks`, the same
blocks on the same rank of every pod), and the mean and error feedback
come back to the shards, with the whole leaf's bits.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from ..core.tensorshrink import linear_base_fit
from ..kernels.base_fit import _fma32
from ..parallel.sharding import P, mesh_axes, shard_map_compat, tree_map_with_path
from ._tree import leaves, tree_map, unflatten

__all__ = ["GradCompressConfig", "PodBlocks", "compressed_psum_shards", "compressed_psum_tree",
           "compression_wire_bytes"]


@dataclasses.dataclass(frozen=True)
class GradCompressConfig:
    block: int = 256
    bits: int = 8
    min_leaf_size: int = 65_536  # smaller leaves ride the wire uncompressed
    axis: str = "pod"

    @property
    def qmax(self) -> int:
        return 2 ** (self.bits - 1) - 1


def _world(group) -> int:
    return dist.get_world_size(group) if dist.is_available() and dist.is_initialized() else 1


def _all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    if _world(group) > 1:
        dist.all_reduce(x, op=op, group=group)
    return x


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """[n, *x.shape]: every pod's x in pod order."""
    n = _world(group)
    if n == 1:
        return x[None]
    out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out.reshape(n, *x.shape)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once: the reference's jitted exchange
    contracts ``base + q * step`` into a fused multiply-add."""
    return _fma32(c, a.double() * b.double())


def _pod_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the leading pod axis, in pod order."""
    acc = x[0]
    for i in range(1, x.shape[0]):
        acc = acc + x[i]
    return acc


def _compress_leaf(g: torch.Tensor, ef: torch.Tensor, cfg: GradCompressConfig, group=None):
    """One leaf: returns (the pod mean of the gradient in float32, the new
    error feedback)."""
    flat = g.to(torch.float32).reshape(-1) + ef.reshape(-1)
    size = flat.shape[0]
    pad = (-size) % cfg.block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    mean, new_ef = _compress_blocks(flat.reshape(-1, cfg.block), cfg, group)
    return (mean.reshape(-1)[:size].reshape(g.shape), new_ef.reshape(-1)[:size].reshape(g.shape))


def _compress_blocks(xb: torch.Tensor, cfg: GradCompressConfig, group=None):
    """The exchange of the blocks xb [M, block] (a flattened gradient plus
    its error feedback, zero-padded to whole blocks): (the pods' mean
    [M, block], the new error feedback [M, block]).  Each block's numbers
    depend on that block alone (and its twins on the other pods), but for
    the fit's order, which differs for a single row (``base_fit``)."""
    n = _world(group)
    theta, slope = linear_base_fit(xb)
    theta = theta.to(torch.bfloat16).to(torch.float32)
    slope = slope.to(torch.bfloat16).to(torch.float32)
    t = torch.arange(cfg.block, dtype=torch.float32, device=xb.device)[None, :]
    r = xb - (theta + slope * t)
    # pod-shared quantization step so the summed ints dequantize coherently
    peak = _all_reduce(torch.amax(torch.abs(r), dim=1, keepdim=True), dist.ReduceOp.MAX, group)
    step = torch.div(peak, torch.tensor(float(cfg.qmax), device=xb.device))
    step = torch.clamp_min(step, 1e-12)
    q = torch.clamp(torch.round(r / step), -cfg.qmax, cfg.qmax).to(torch.int8)
    base = theta + slope * t  # exact: a bf16 slope times t < 2**8
    local_deq = _fma(q.to(torch.float32), step, base)
    new_ef = xb - local_deq

    if cfg.bits <= 4:
        # nibble-pack: two 4-bit residuals per wire byte
        hiq = (q[:, ::2].to(torch.int32) & 0xF) << 4
        loq = q[:, 1::2].to(torch.int32) & 0xF
        packed = (hiq | loq).to(torch.int8)
        p_all = _all_gather(packed, group).to(torch.int32)  # [n, M, B/2]
        hi_u = p_all >> 4
        lo_u = p_all & 0xF
        sx = lambda x: torch.where(x > 7, x - 16, x)  # sign-extend 4-bit two's complement
        q_all = torch.stack([sx(hi_u & 0xF), sx(lo_u)], dim=-1).reshape(
            p_all.shape[0], p_all.shape[1], -1)
    else:
        q_all = _all_gather(q, group)  # [n, M, B] int8
    th_all = _all_gather(theta.to(torch.bfloat16), group)
    sl_all = _all_gather(slope.to(torch.bfloat16), group)
    q_sum = _pod_sum(q_all.to(torch.float32))
    base_sum = _pod_sum(th_all.to(torch.float32)) + _pod_sum(sl_all.to(torch.float32)) * t
    g_sum = _fma(q_sum, step, base_sum)
    return torch.div(g_sum, torch.tensor(float(n), device=xb.device)), new_ef


def compressed_psum_tree(grads, ef_tree, cfg: GradCompressConfig, group=None):
    """Tree-wise compressed mean over the pod group.  Small leaves use a
    plain all-reduce (negligible wire share).  Returns (mean_grads, new_ef)."""
    n = torch.tensor(float(_world(group)))

    def one(g, ef):
        if g.numel() < cfg.min_leaf_size:
            s = _all_reduce(g.to(torch.float32).clone(), dist.ReduceOp.SUM, group)
            return torch.div(s, n.to(g.device)), ef
        return _compress_leaf(g, ef, cfg, group)

    outs = [one(g, e) for g, e in zip(leaves(grads), leaves(ef_tree))]
    return unflatten(grads, [o[0] for o in outs]), unflatten(grads, [o[1] for o in outs])


class PodBlocks:
    """The ranks of one pod (every mesh axis but ``axis``) and each leaf's
    whole-block layout over them: the compressed exchange of a sharded
    state (``train_step.make_compressed_train_step``).

    A leaf of N elements is cut, as :func:`compressed_psum_tree` cuts it
    whole, into M = ceil(N / block) blocks of its flattening (the last
    zero-padded).  Rank j of the P ranks of a pod owns blocks j c .. (j +
    1) c - 1, c = ceil(M / P) (at least 2 where M is: the fit sums a single
    row in another order), zeros past M.  The same rank of every pod owns
    the same blocks, so the exchange over ``axis`` gives each block the
    bits it gets on the whole leaf.  :meth:`to_blocks` moves this rank's
    shard of a leaf (placed by a spec over the pod's axes) into its blocks,
    :meth:`from_blocks` moves values of those blocks back into the shard's
    layout: one ``all_to_all_single`` over the pod's ranks each way (a
    shard's elements, read in its own order, come in flat order, and so
    does a range of blocks).  What depends on a leaf's shape and spec alone
    (the counts each rank sends) is worked out once."""

    def __init__(self, mesh, axis: str):
        sizes = mesh_axes(mesh)
        self.axes = tuple(a for a in sizes if a != axis)
        self.sizes = {a: sizes[a] for a in self.axes}
        self.n = math.prod(self.sizes.values())
        self.group, self.rank, self._plans = None, 0, {}
        # each pod rank's coordinates along self.axes, in its group's order
        self.coords = [dict.fromkeys(self.axes, 0)]
        if self.n > 1:
            names = list(sizes)
            grid = mesh.mesh.movedim(names.index(axis), 0).reshape(sizes[axis], -1)
            mine = dist.get_rank()
            for plane in grid.tolist():  # every rank creates every pod's group
                group = dist.new_group(sorted(plane))
                if mine in plane:
                    self.group = group
            ranks = dist.get_process_group_ranks(self.group)
            self.rank = ranks.index(mine)
            at = [(mesh.mesh == r).nonzero()[0].tolist() for r in ranks]
            self.coords = [{a: c[names.index(a)] for a in self.axes} for c in at]
        self._rank_of = torch.empty([self.sizes[a] for a in self.axes], dtype=torch.int64)
        for j, c in enumerate(self.coords):
            self._rank_of[tuple(c[a] for a in self.axes)] = j

    def _box(self, j: int, shape, spec) -> tuple[list, list, list]:
        """Pod rank j's shard of a ``shape`` leaf placed by ``spec``: each
        dim's first index and length, and its split's axes (major first)."""
        first, size, axes = [], [], []
        for d, n in enumerate(shape):
            part = spec[d] if d < len(spec) else None
            names = [a for a in ((part,) if isinstance(part, str) else (part or ()))
                     if a in self.sizes]
            k, count = 0, 1
            for a in names:
                k, count = k * self.sizes[a] + self.coords[j][a], count * self.sizes[a]
            first.append(k * (n // count))
            size.append(n // count)
            axes.append(names)
        return first, size, axes

    def _canonical(self, axes: list) -> list:
        """For each pod rank, the rank that sends its shard's elements: the
        one of those holding the same shard (the same coordinates along the
        axes that split the leaf) at coordinate 0 along the others."""
        named = {a for names in axes for a in names}
        return [int(self._rank_of[tuple(c[a] if a in named else 0 for a in self.axes)])
                for c in self.coords]

    def _plan(self, shape, spec, block: int, device) -> dict:
        key = (tuple(shape), spec, block, device)
        if key in self._plans:
            return self._plans[key]
        total = math.prod(shape)
        m = -(-total // block)
        c = -(-m // self.n)
        if m >= 2:
            c = max(c, 2)
        _, local, axes = self._box(self.rank, shape, spec)
        plan = {"span": c * block, "local": tuple(local),
                "valid": max(0, min(c * block, total - self.rank * c * block))}
        if self.n > 1:
            canon = self._canonical(axes)
            # count[i]: this rank's block elements that rank i's shard holds
            count = torch.bincount(self._owners(plan, shape, spec, device), minlength=self.n)
            back = count[torch.tensor(canon, device=device)]
            mine = torch.empty_like(back)
            dist.all_to_all_single(mine, back.contiguous(), group=self.group)
            starts = [0] + torch.cumsum(count, 0).tolist()
            plan.update(recv=count.tolist(), starts=starts, canon=canon, back=back.tolist(),
                        mine=mine.tolist(),
                        send=mine.tolist() if canon[self.rank] == self.rank else [0] * self.n)
        self._plans[key] = plan
        return plan

    def _owners(self, plan: dict, shape, spec, device) -> torch.Tensor:
        """For each element of this rank's blocks (those past the leaf's end
        not listed), the sending pod rank of the shard that holds it."""
        flat = torch.arange(self.rank * plan["span"], self.rank * plan["span"] + plan["valid"],
                            device=device)
        _, size, axes = self._box(0, shape, spec)
        owner = torch.zeros_like(flat)
        strides = self._rank_of.stride()
        for d in reversed(range(len(shape))):
            idx = flat % shape[d]
            flat = torch.div(flat, shape[d], rounding_mode="floor")
            q = torch.div(idx, size[d], rounding_mode="floor")
            for a in reversed(axes[d]):
                owner += (q % self.sizes[a]) * strides[self.axes.index(a)]
                q = torch.div(q, self.sizes[a], rounding_mode="floor")
        return self._rank_of.to(device).reshape(-1)[owner]

    def to_blocks(self, x: torch.Tensor, shape, spec, block: int) -> tuple:
        """This rank's blocks [c, block] of the leaf of ``shape`` whose
        shard under ``spec`` is ``x``, and the order in which its elements
        arrived (for :meth:`from_blocks`)."""
        plan = self._plan(shape, spec, block, x.device)
        if self.n == 1:
            flat = x.reshape(-1)
            pad = plan["span"] - flat.shape[0]
            return (torch.cat([flat, flat.new_zeros(pad)]) if pad else flat).view(-1, block), None
        got = torch.empty(sum(plan["recv"]), dtype=x.dtype, device=x.device)
        send = x.reshape(-1) if sum(plan["send"]) else x.new_empty(0)
        dist.all_to_all_single(got, send.contiguous(), plan["recv"], plan["send"],
                               group=self.group)
        order = torch.argsort(self._owners(plan, shape, spec, x.device), stable=True)
        flat = torch.zeros(plan["span"], dtype=x.dtype, device=x.device)
        flat[order] = got
        return flat.view(-1, block), order

    def from_blocks(self, values: tuple, order, shape, spec, block: int) -> list:
        """Each of ``values`` (this rank's blocks' values, [c, block] each)
        in the shard's layout, on every rank that holds the shard."""
        plan = self._plan(shape, spec, block, values[0].device)
        if self.n == 1:
            return [v.reshape(-1)[:plan["valid"]].reshape(plan["local"]) for v in values]
        starts, canon = plan["starts"], plan["canon"]
        index = torch.cat([order[starts[c]:starts[c + 1]] for c in canon])
        stacked = torch.stack([v.reshape(-1)[:plan["valid"]] for v in values], dim=1)[index]
        out = torch.empty((math.prod(plan["local"]), len(values)), dtype=stacked.dtype,
                          device=stacked.device)
        dist.all_to_all_single(out, stacked, plan["mine"], plan["back"], group=self.group)
        return [out[:, i].reshape(plan["local"]) for i in range(len(values))]


def compressed_psum_shards(grads, ef_tree, shapes: list, specs: list, cfg: GradCompressConfig,
                           blocks: PodBlocks, group=None):
    """:func:`compressed_psum_tree` of the whole leaves, on this rank's
    shards: ``grads`` and ``ef_tree`` hold each leaf's shard under its spec
    (``specs``, in leaf order; ``shapes`` the whole leaves' shapes), and the
    mean and new error feedback come back so placed, with the bits that
    the whole leaves' exchange gives them.  A leaf under ``min_leaf_size``
    is summed over ``group`` elementwise; a larger one goes through its
    blocks (``blocks``, the pod's layout)."""
    n = torch.tensor(float(_world(group)))

    def one(g, ef, shape, spec):
        if math.prod(shape) < cfg.min_leaf_size:
            s = _all_reduce(g.to(torch.float32).clone(), dist.ReduceOp.SUM, group)
            return torch.div(s, n.to(g.device)), ef
        xb, order = blocks.to_blocks(g.to(torch.float32) + ef, shape, spec, cfg.block)
        mean, new_ef = _compress_blocks(xb, cfg, group)
        return tuple(blocks.from_blocks((mean, new_ef), order, shape, spec, cfg.block))

    outs = [one(*args) for args in zip(leaves(grads), leaves(ef_tree), shapes, specs,
                                       strict=True)]
    return unflatten(grads, [o[0] for o in outs]), unflatten(grads, [o[1] for o in outs])


def _concat(tree) -> tuple[torch.Tensor, list]:
    """The leaves as one float32 vector, and their shapes."""
    flat = leaves(tree)
    return torch.cat([x.to(torch.float32).reshape(-1) for x in flat]), [x.shape for x in flat]


def _split(vec: torch.Tensor, like, shapes: list):
    outs, off = [], 0
    for shape in shapes:
        n = shape.numel()
        outs.append(vec[off:off + n].reshape(shape))
        off += n
    return unflatten(like, outs)


def make_crosspod_exchange(mesh, comp_cfg: GradCompressConfig | None, param_spec_tree,
                           flat: bool = False):
    """The cross-pod gradient exchange stage: ``exchange(grads_stacked,
    ef)`` with every leaf of ``grads_stacked`` carrying a leading pod dim
    (a DTensor over the mesh, or the whole tensor that every rank holds);
    returns (the pods' mean gradient, the new error feedback) as DTensors
    placed by ``param_spec_tree``.

    Each rank exchanges exactly its own shard of each leaf (all mesh axes
    manual).  ``comp_cfg=None``: the float32 mean over ``"pod"`` (the
    baseline wire).  ``flat``: one exchange of all leaves concatenated
    instead of one a leaf (the compressed one then ignores
    ``min_leaf_size``, as the reference's does)."""
    axis = comp_cfg.axis if comp_cfg else "pod"
    group = mesh.get_group(axis)
    n = torch.tensor(float(_world(group)))

    def exchange(grads_stacked, ef):
        local = tree_map(lambda x: x[0], grads_stacked)
        if comp_cfg is None:
            if flat:
                vec, shapes = _concat(local)
                s = _all_reduce(vec, dist.ReduceOp.SUM, group)
                return _split(torch.div(s, n.to(s.device)), local, shapes), ef
            return tree_map(lambda g: torch.div(
                _all_reduce(g.to(torch.float32).clone(), dist.ReduceOp.SUM, group),
                n.to(g.device)), local), ef
        if flat:
            # all leaves in one exchange: 4 collectives a step instead of ~4 a leaf
            vec, shapes = _concat(local)
            g_sum, new_e = _compress_leaf(vec, _concat(ef)[0], comp_cfg, group)
            return _split(g_sum, local, shapes), _split(new_e, local, shapes)
        return compressed_psum_tree(local, ef, comp_cfg, group=group)

    stacked = tree_map_with_path(lambda _, s: P(axis, *s), param_spec_tree)
    return shard_map_compat(exchange, mesh=mesh, in_specs=(stacked, param_spec_tree),
                            out_specs=(param_spec_tree, param_spec_tree), check_vma=False)


def compression_wire_bytes(params, cfg: GradCompressConfig) -> tuple[int, int]:
    """(compressed, uncompressed-f32) cross-pod bytes per step, analytic."""
    comp = 0
    raw = 0
    for leaf in leaves(params):
        size = leaf.numel()
        raw += size * 4
        if size < cfg.min_leaf_size:
            comp += size * 4
        else:
            m = -(-size // cfg.block)
            comp += size * 1 + m * (2 + 2)  # int8 + bf16 theta/slope
    return comp, raw
