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
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..core.tensorshrink import linear_base_fit
from ..kernels.base_fit import _fma32
from ..parallel.sharding import P, shard_map_compat, tree_map_with_path
from ._tree import leaves, tree_map, unflatten

__all__ = ["GradCompressConfig", "compressed_psum_tree", "compression_wire_bytes"]


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
    n = _world(group)
    flat = g.to(torch.float32).reshape(-1) + ef.reshape(-1)
    size = flat.shape[0]
    pad = (-size) % cfg.block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    xb = flat.reshape(-1, cfg.block)

    theta, slope = linear_base_fit(xb)
    theta = theta.to(torch.bfloat16).to(torch.float32)
    slope = slope.to(torch.bfloat16).to(torch.float32)
    t = torch.arange(cfg.block, dtype=torch.float32, device=g.device)[None, :]
    r = xb - (theta + slope * t)
    # pod-shared quantization step so the summed ints dequantize coherently
    peak = _all_reduce(torch.amax(torch.abs(r), dim=1, keepdim=True), dist.ReduceOp.MAX, group)
    step = torch.div(peak, torch.tensor(float(cfg.qmax), device=g.device))
    step = torch.clamp_min(step, 1e-12)
    q = torch.clamp(torch.round(r / step), -cfg.qmax, cfg.qmax).to(torch.int8)
    base = theta + slope * t  # exact: a bf16 slope times t < 2**8
    local_deq = _fma(q.to(torch.float32), step, base)
    new_ef = (xb - local_deq).reshape(-1)[:size].reshape(g.shape)

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
    g_sum = _fma(q_sum, step, base_sum).reshape(-1)[:size].reshape(g.shape)
    return torch.div(g_sum, torch.tensor(float(n), device=g.device)), new_ef


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
