"""Explicit collectives of the port's sharded steps: what GSPMD derives for
the reference from its jit shardings (``param_specs``) and its ``shard()``
hints, written out with ``torch.distributed`` over a DeviceMesh's groups.

A step on a mesh (``training.train_step``) holds each param, its gradient
and both AdamW moments as this rank's shard under the param's spec
(:meth:`Shards.local`; ``Shard(d)`` on each mesh axis the spec names for
dim d, as ``param_shardings`` places them).  The layers find :class:`Shards`
on the active rules (``AxisRules.shards``) and call the collectives
themselves:

* :meth:`Shards.gather` (ZeRO-3): a block's leaf gathered over the mesh
  axes its compute does not split (``all_gather_into_tensor``, inner axis
  first), inside the block's remat.  Its backward reduce-scatters the
  float32 gradient (a sum) over the axes whose ranks add different
  contributions (the batch axes; ``"model"`` where the tensor-parallel
  compute reads a slice of the gathered leaf) and takes its own piece
  along the others (``"model"`` where every rank computes the same), so
  the leaf's gradient arrives as this rank's shard.
* :func:`copy_to` and :func:`reduce_from`, Megatron-LM's f and g: identity
  forward and all_reduce backward at the input of a column-split product
  (or on a replicated leaf that split compute reads: its gradient is
  partial on each rank); all_reduce forward and identity backward after a
  row-split one.  :func:`sum_over` sums forward and backward (a statistic
  over a dim that the ranks split, RWKV's norm).
* :func:`gather_dim`: an activation's pieces along a split dim gathered,
  with a gradient that sums (the ranks read different slices of the whole)
  or takes this rank's piece (the ranks compute the same from it).
  :func:`all_gather_dim` (no gradient): a prefill's cache and last logits
  made whole over ``"model"``, and a decode's local query heads.

The decode caches live in ``cache_specs``' layout (the flash-decoding
one): batch over the batch axes, the cache's sequence (a recurrent
state's width or heads) over ``"model"`` where the axis divides it.
:meth:`Shards.local` and :meth:`Shards.wrap` take a cache tree as they
take params (dataclass instances are nodes), :meth:`Shards.cache_pieces`
tells each attention layer where its piece of the sequence sits (a
:class:`Piece`, or None where the spec leaves the dim whole or
``"model"`` is 1), and :func:`merge_partials` is the flash-decoding
combine of the ranks' partial softmaxes.  A recurrent or WKV state's
piece is what the layer's split compute reads and writes itself.

A step's params are placed by :func:`step_specs`: ``param_specs``, and a
leaf whose dim its axes do not divide (a padded vocabulary that
``"model"`` does not divide) raises, as JAX's shardings refuse it.

Query heads that ``force_head_sharding`` splits over a ``"model"`` axis
that does not divide them take GSPMD's padded tiling (:func:`head_range`:
tiles of ceil(n / m) heads, the last ones short or empty);
:func:`gather_heads` gathers such uneven pieces of an activation.

A group of one still runs its collectives (each then copies), and every
gathered tensor is contiguous in the leaf's own layout, so a one-rank mesh
computes what one device computes, bit for bit.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..configs.base import ModelConfig
from .partition import _spec_for_leaf, fsdp_axes_for, param_specs, shard_shape
from .sharding import P, local_shard, mesh_axes, spec_placements, tree_map_with_path

__all__ = ["Piece", "Shards", "all_gather_dim", "copy_to", "gather_dim", "gather_heads",
           "head_range", "merge_partials", "reduce_from", "step_specs", "sum_over"]


def all_gather_dim(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The group's pieces of ``x`` concatenated along ``dim``, in rank order,
    contiguous (no gradient): stacked [n, ...] by the collective, then one
    copy into place where ``dim`` is not the first."""
    dim %= x.ndim
    x = x.contiguous()
    out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=group)
    if dim == 0:
        return out
    shape = (*x.shape[:dim], n * x.shape[dim], *x.shape[dim + 1:])
    return out.view(n, *x.shape).movedim(0, dim).reshape(shape)


def _reduce_scatter(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """This rank's piece along ``dim`` of the group's sum of ``x``: the n
    pieces stacked [n, ...] (one copy where ``dim`` is not the first), then
    the collective."""
    size = x.shape[dim] // n
    x = x.reshape(*x.shape[:dim], n, size, *x.shape[dim + 1:]).movedim(dim, 0).contiguous()
    out = torch.empty(x.shape[1:], dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, x.view(n * out.shape[0], *out.shape[1:]), group=group)
    return out


class _Gather(torch.autograd.Function):
    """A leaf gathered by ``steps`` of (dim, group, n, index, summed); the
    backward reduce-scatters (summed) or takes its own piece, in reverse."""

    @staticmethod
    def forward(ctx, x, steps):
        ctx.steps, ctx.dtype = steps, x.dtype
        for dim, group, n, _, _ in steps:
            x = all_gather_dim(x, dim, group, n)
        return x

    @staticmethod
    def backward(ctx, grad):
        g = grad.float()
        for dim, group, n, index, summed in reversed(ctx.steps):
            if summed:
                g = _reduce_scatter(g, dim, group, n)
            else:
                size = g.shape[dim] // n
                g = g.narrow(dim, index * size, size).contiguous()
        return g.to(ctx.dtype), None


class _CopyTo(torch.autograd.Function):
    """Megatron-LM's f: identity forward, the gradient summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    """Megatron-LM's g: summed over the group forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SumOver(torch.autograd.Function):
    """Summed over the group forward and backward: a partial sum that every
    rank's outputs read whole."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron-LM's f over ``group``; ``x`` itself where ``group`` is None
    (no tensor parallelism)."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron-LM's g over ``group``; ``x`` itself where ``group`` is
    None."""
    return x if group is None else _ReduceFrom.apply(x, group)


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, forward and backward (each rank's
    outputs depend on the sum of every rank's part)."""
    return _SumOver.apply(x, group)


def gather_dim(x: torch.Tensor, dim: int, group, n: int, index: int,
               summed: bool) -> torch.Tensor:
    """This rank's piece ``x`` (rank ``index`` of ``n``) of an activation
    gathered along ``dim`` over ``group``, with a gradient: the group's sum
    scattered back (``summed``: each rank's compute reads its own slice of
    the whole) or this rank's piece of it (every rank computes the same
    from the whole)."""
    return _Gather.apply(x, ((dim % x.ndim, group, n, index, summed),))


@dataclasses.dataclass(frozen=True)
class Piece:
    """This rank's piece of a cache dim split over ``"model"``: its first
    global index, its length, the dim's global length, and the model axis's
    group and size."""

    first: int
    size: int
    total: int
    group: object
    n: int


def merge_partials(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor, group,
                   dtype: torch.dtype) -> torch.Tensor:
    """The flash-decoding combine over ``group`` of each rank's float32 row
    max ``m`` and sum ``l`` (``[..., 1]``) and unnormalised partial output
    ``o`` (``[..., D]``): M, the ranks' max (one all_reduce), then L = the
    sum of exp(m - M) l and O = the sum of exp(m - M) o in float32 (one
    packed all_reduce), and O / L in ``dtype``.  A rank whose keys are all
    masked (m = -1e30) has exp(m - M) = 0 and adds nothing."""
    top = m.clone()
    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
    scale = torch.exp(m - top)
    packed = torch.cat([(scale * l).reshape(-1), (scale * o).reshape(-1)])
    dist.all_reduce(packed, group=group)
    total, out = packed.split([l.numel(), o.numel()])
    return (out.view(o.shape) / total.view(l.shape)).to(dtype)


def _names(part) -> tuple:
    return () if part is None else (part if isinstance(part, tuple) else (part,))


def _contiguous_stride(shape) -> tuple:
    return tuple(math.prod(shape[d + 1:]) for d in range(len(shape)))


class Shards:
    """This rank's place on a DeviceMesh for a step whose params are its
    ``param_specs`` shards: each axis's size, this rank's index along it,
    its process group, and the config's fsdp axes.  What depends on a
    leaf's spec alone (its placements, its gathers' plan, a tree's specs)
    is worked out once and kept: a step repeats only its collectives and
    its DTensors' wrapping."""

    def __init__(self, mesh, cfg: ModelConfig):
        self.mesh, self.cfg = mesh, cfg
        self.sizes = mesh_axes(mesh)
        self.index = dict(zip(self.sizes, mesh.get_coordinate()))
        self.groups = {a: mesh.get_group(a) for a in self.sizes}
        self.fsdp = fsdp_axes_for(cfg, mesh)
        self._specs: dict = {}  # a tree's leaf shapes -> its specs
        self._placements: dict = {}  # spec -> placements
        self._plans: dict = {}  # (path, ndim, keep, summed_model) -> gather steps
        self._shapes: set = set()  # (shape, spec) checked by shard_shape

    def specs(self, params):
        """:func:`step_specs` of ``params``, made once for each structure of
        leaf shapes."""
        key = _shape_key(params)
        if key not in self._specs:
            self._specs[key] = step_specs(params, self.cfg, self.mesh)
        return self._specs[key]

    def placements(self, spec: P) -> tuple:
        if spec not in self._placements:
            self._placements[spec] = spec_placements(self.mesh, spec)
        return self._placements[spec]

    def gather(self, x: torch.Tensor, path: tuple, keep: tuple = (),
               summed_model: bool = False) -> torch.Tensor:
        """``x``, this rank's shard of the leaf at ``path`` (a block's own
        leaves take their block-relative path), gathered over every axis
        its spec names but those in ``keep``.  Along a batch axis the
        gradient is summed; along ``"model"`` summed when ``summed_model``
        (the ranks read different slices of the whole), else this rank's
        piece of it (the ranks compute the same)."""
        key = (path, x.ndim, keep, summed_model)
        steps = self._plans.get(key)
        if steps is None:
            steps = []
            spec = _spec_for_leaf(path, x, self.fsdp)
            for dim, part in enumerate(spec):
                for name in reversed(_names(part)):  # the inner axis first
                    if name not in keep and name in self.sizes:
                        steps.append((dim, self.groups[name], self.sizes[name],
                                      self.index[name], name != "model" or summed_model))
            steps = self._plans[key] = tuple(steps)
        return _Gather.apply(x, steps) if steps else x

    def local(self, tree, specs):
        """Each leaf's shard on this rank: a DTensor's local tensor (on this
        mesh, redistributed where its placements are not its spec's), or
        the piece of a plain tensor that every rank holds whole (no
        communication).  A dim its axes do not divide raises
        ``ValueError``, as JAX's shardings do."""
        def one(leaf, spec):
            if (leaf.shape, spec) not in self._shapes:
                shard_shape(leaf.shape, spec, self.mesh)
                self._shapes.add((leaf.shape, spec))
            pl = self.placements(spec)
            if isinstance(leaf, DTensor):
                if leaf.device_mesh != self.mesh:
                    raise ValueError(f"a DTensor leaf on {leaf.device_mesh}, not the step's "
                                     f"mesh {self.mesh}")
                if tuple(leaf.placements) != pl:
                    leaf = leaf.redistribute(self.mesh, pl)
                return leaf.to_local()
            return local_shard(leaf, self.mesh, pl)
        return _zip_map(one, tree, specs)

    def cut(self, tree, specs, axes: tuple):
        """Each plain leaf of ``tree`` cut to this rank's piece along the
        mesh axes in ``axes`` alone (its other dims as they are: a leaf
        that holds this rank's rows already), a copy where the piece is
        smaller than the leaf, so that the whole can be freed."""
        def one(leaf, spec):
            piece = local_shard(leaf, self.mesh, spec_placements(self.mesh, spec, axes))
            return piece.clone() if piece.numel() != leaf.numel() else piece
        return _zip_map(one, tree, specs)

    def wrap(self, tree, specs, like):
        """DTensors of the local ``tree`` placed by ``specs``, each of its
        ``like`` leaf's global shape."""
        def one(t, spec, ref):
            return DTensor.from_local(t, self.mesh, self.placements(spec), run_check=False,
                                      shape=ref.shape, stride=_contiguous_stride(ref.shape))
        return _zip_map(one, tree, specs, like)

    def cache_pieces(self, caches, specs):
        """Each attention or latent cache of a decode tree (a dataclass
        instance with ``kpos``) as the :class:`Piece` of its sequence that
        this rank holds, or None where ``specs`` (``cache_specs``') leave
        the sequence whole or ``"model"`` is 1; None for a recurrent or WKV
        state (the layer's split compute holds its own piece).  ``caches``
        has the global shapes."""
        n = self.sizes.get("model", 1)

        def walk(tree, spec):
            if isinstance(tree, dict):
                return {k: walk(tree[k], spec[k]) for k in tree}
            if isinstance(tree, (list, tuple)):
                return type(tree)(walk(t, s) for t, s in zip(tree, spec, strict=True))
            if not hasattr(tree, "kpos"):
                return None
            total = tree.kpos.shape[-1]
            if n == 1 or "model" not in _names(spec.kpos[-1]):
                return None
            size = total // n
            return Piece(self.index["model"] * size, size, total, self.groups["model"], n)

        return walk(caches, specs)

    def counted(self, spec: P) -> bool:
        """Whether this rank's piece of a leaf placed by ``spec`` counts in a
        sum over the mesh: once a piece, by the rank at index 0 of every
        axis along which the piece is replicated."""
        split = {n for part in spec for n in _names(part)}
        return all(self.index[a] == 0 for a in self.sizes if a not in split)


def head_range(n_heads: int, sh: Shards) -> tuple[int, int]:
    """(first, count) of the query heads that this rank computes where a
    step's rules split ``n_heads`` over ``"model"``: GSPMD's padded tiling,
    tiles of c = ceil(n_heads / m) heads on the m model ranks in order,
    rank r holding [r c, min(r c + c, n_heads)), short or empty at the end
    (40 heads on 16 ranks: 3 each on ranks 0-12, head 39 on rank 13, none
    on 14-15).  Where m divides the heads: r * (n_heads / m) and
    n_heads / m."""
    c = -(-n_heads // sh.sizes["model"])
    first = min(sh.index["model"] * c, n_heads)
    return first, min(c, n_heads - first)


def gather_heads(x: torch.Tensor, dim: int, n_heads: int, sh: Shards) -> torch.Tensor:
    """Every rank's query heads along ``dim`` of ``x`` (this rank's
    :func:`head_range` of ``n_heads``), concatenated in head order, no
    gradient: each piece padded with zeros to the tile of ceil(n_heads / m)
    heads, gathered over ``"model"``, the padding at the end dropped, as
    GSPMD pads an uneven split."""
    m = sh.sizes["model"]
    c = -(-n_heads // m)
    dim %= x.ndim
    if x.shape[dim] < c:
        pad = list(x.shape)
        pad[dim] = c - x.shape[dim]
        x = torch.cat([x, x.new_zeros(pad)], dim=dim)
    out = all_gather_dim(x, dim, sh.groups["model"], m)
    return out if m * c == n_heads else out.narrow(dim, 0, n_heads)


def step_specs(params, cfg: ModelConfig, mesh):
    """``param_specs`` as a sharded step places its params; on a mesh
    without ``"model"`` (the compressed step's ``"pod"`` mesh) no leaf
    names it.  A leaf with a dim that its axes do not divide (a padded
    vocabulary that ``"model"`` does not divide) raises ``ValueError``
    naming the leaf, its spec and the mesh axes, as JAX's shardings refuse
    it."""
    specs = param_specs(params, cfg, mesh)
    axes = mesh_axes(mesh)
    if "model" not in axes:  # a mesh of "pod" or ("pod", "data"): nothing splits over it
        specs = tree_map_with_path(lambda _, s: P(*(_present(part, axes) for part in s)), specs)

    def divides(path, leaf):
        spec = _leaf_at(specs, path)
        try:
            shard_shape(leaf.shape, spec, mesh)
        except ValueError as e:
            raise ValueError(f"{'.'.join(map(str, path))}: {e} (mesh {axes})") from None

    tree_map_with_path(divides, params)
    return specs


def _leaf_at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _present(part, axes):
    """A spec entry without the axes that the mesh lacks."""
    names = tuple(n for n in _names(part) if n in axes)
    return names[0] if len(names) == 1 else (names or None)


def _shape_key(tree):
    """A hashable key of ``tree``'s structure and leaf shapes."""
    if isinstance(tree, dict):
        return tuple((k, _shape_key(v)) for k, v in sorted(tree.items()))
    if isinstance(tree, (list, tuple)):
        return tuple(_shape_key(t) for t in tree)
    return None if tree is None else tuple(tree.shape)


def _zip_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (spec trees have :class:`P` leaves; dataclass instances, the
    caches, are nodes)."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_map(fn, t, *xs) for t, *xs in zip(tree, *rest, strict=True))
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: _zip_map(fn, getattr(tree, f.name),
                                              *(getattr(r, f.name) for r in rest))
                             for f in dataclasses.fields(tree)})
    if tree is None:
        return None
    return fn(tree, *rest)
