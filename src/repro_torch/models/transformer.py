"""Decoder-only and encoder-decoder transformer assembly in PyTorch,
counterpart of ``repro.models.transformer``.

Layers are grouped into the smallest repeating pattern (``cfg.block_group``:
``("attn",)`` for the dense archs, ``("rec", "rec", "local")`` for
recurrentgemma, 4 x ``"attn"`` + ``"cross"`` for the VLM, ``("attn",
"attn")`` with a dense and an MoE FFN for llama4) and each position's params
are stacked on a leading ``[G, ...]`` axis, as the reference stacks them for
``lax.scan``; a Python loop over that axis takes the scan's place.  Leading
layers that differ (deepseek's dense first layer) run first as the
``"prefix"`` list, and a non-divisible tail (recurrentgemma's 38 = 12 x 3 +
2) last as the ``"tail"`` list.  Prefill emits the caches in the same
layout, and decode writes into them in place.

Modes: ``"train"`` (no caches), ``"prefill"`` (emit caches and states),
``"decode"`` (one token step against caches and states).

In ``"train"`` mode each stack's groups come from one ``torch.unbind`` (its
backward writes the stack's gradient once, where a ``tree[g]`` a group
would write a full-size zero tensor a group), and ``cfg.remat`` recomputes
each group position's block in the backward pass
(``torch.utils.checkpoint``, non-reentrant), as the reference wraps its
scan body in ``jax.checkpoint``.  ``remat_policy="nothing"`` keeps only
the block's input; ``"dots"`` (the reference's
``dots_with_no_batch_dims_saveable``) also keeps the outputs of the 2-D
projection matmuls (``aten.mm`` and ``aten.addmm``, a selective-checkpoint
policy) and recomputes everything else, the batched matmuls and the
attention kernel included.  Both give the same gradients, bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from ..configs.base import ModelConfig
from ..core.errors import ConfigError
from .layers import (
    COMPUTE_DTYPE,
    AttnCache,
    MLACache,
    RecState,
    RwkvState,
    _init_device,
    attention_apply,
    attention_init,
    mla_apply,
    mla_init,
    mlp_apply,
    mlp_init,
    moe_apply,
    moe_init,
    rglru_apply,
    rglru_init,
    rmsnorm,
    rmsnorm_init,
    rwkv_apply,
    rwkv_init,
)

__all__ = [
    "apply_stack",
    "block_apply",
    "block_init",
    "cross_prefill_cache",
    "embed_tokens",
    "encode",
    "init_cache_for_kind",
    "init_params",
    "logits_from",
    "make_decode_caches",
]

Params = dict


def _stacked_only(cfg: ModelConfig) -> None:
    if not cfg.scan_blocks:
        raise NotImplementedError(f"{cfg.name}: the port stacks its layer groups (scan_blocks)")


# ------------------------------------------------------------ block structs
def _block_kind(cfg: ModelConfig, layer_idx: int) -> str:
    return cfg.block_group[layer_idx % len(cfg.block_group)]


def block_init(gen: torch.Generator, cfg: ModelConfig, layer_idx: int, kind: str,
               encoder: bool = False, device=None) -> Params:
    dev = _init_device(gen, device)
    p: Params = {"ln1": rmsnorm_init(cfg.d_model, cfg, dev),
                 "ln2": rmsnorm_init(cfg.d_model, cfg, dev)}
    if kind in ("attn", "local", "cross"):
        p["attn"] = (mla_init(gen, cfg, device=dev) if (cfg.mla and not encoder)
                     else attention_init(gen, cfg, device=dev))
    elif kind == "rec":
        p["rec"] = rglru_init(gen, cfg, device=dev)
    elif kind == "rwkv":
        p["rwkv"] = rwkv_init(gen, cfg, device=dev)
    if kind == "cross" and not encoder:
        p["ln_cross"] = rmsnorm_init(cfg.d_model, cfg, dev)
        p["cross_attn"] = attention_init(gen, cfg, cross=True, device=dev)
    if kind != "rwkv":  # rwkv carries its own channel-mix
        if cfg.layer_uses_moe(layer_idx) and not encoder:
            p["moe"] = moe_init(gen, cfg, device=dev)
        else:
            p["mlp"] = mlp_init(gen, cfg, device=dev)
    return p


def block_apply(
    p: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    kind: str,
    *,
    mode: str,
    positions: torch.Tensor,
    cache: Optional[dict] = None,
    cache_index: Optional[int] = None,
    cross_source: Optional[torch.Tensor] = None,
    encoder: bool = False,
) -> tuple[torch.Tensor, Optional[dict], torch.Tensor]:
    """The mixer (attention, MLA, RG-LRU or RWKV; a cross layer also
    cross-attends to ``cross_source``) then the FFN (MLP or MoE), each
    behind an RMSNorm and a residual.  Returns (x, new cache dict or None,
    the float32 MoE aux loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache: dict = {}
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if kind in ("attn", "local", "cross"):
        if cfg.mla and not encoder:
            y, c = mla_apply(p["attn"], h, cfg, positions=positions, mode=mode,
                             cache=cache.get("self") if cache else None, cache_index=cache_index)
        else:
            y, c = attention_apply(
                p["attn"], h, cfg, positions=positions, mode=mode,
                mask_kind="none" if encoder else ("local" if kind == "local" else "causal"),
                cache=cache.get("self") if cache else None, cache_index=cache_index,
                window=cfg.local_window,
            )
        if c is not None:
            new_cache["self"] = c
        x = x + y
        if kind == "cross" and not encoder:
            hc = rmsnorm(x, p["ln_cross"], cfg.norm_eps)
            if mode == "decode":
                yc, _ = attention_apply(p["cross_attn"], hc, cfg, positions=positions,
                                        mode="decode_cross", cache=cache.get("cross"))
                new_cache["cross"] = cache["cross"]
            else:
                yc, cc = attention_apply(p["cross_attn"], hc, cfg, positions=positions,
                                         mode=mode, kv_source=cross_source)
                if mode == "prefill" and cc is not None:
                    new_cache["cross"] = cc
            x = x + yc
    elif kind == "rec":
        y, st = rglru_apply(p["rec"], h, cfg, mode=mode, state=cache.get("rec") if cache else None)
        if st is not None:
            new_cache["rec"] = st
        x = x + y
    elif kind == "rwkv":
        y, st = rwkv_apply(p["rwkv"], h, cfg, mode=mode,
                           state=cache.get("rwkv") if cache else None)
        if st is not None:
            new_cache["rwkv"] = st
        return x + y, (new_cache or None), aux

    h2 = rmsnorm(x, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        y2, aux = moe_apply(p["moe"], h2, cfg)
    else:
        y2 = mlp_apply(p["mlp"], h2)
    return x + y2, (new_cache or None), aux


# ------------------------------------------------------- prefill cross path
def cross_prefill_cache(p_block: Params, source: torch.Tensor, cfg: ModelConfig) -> AttnCache:
    """Cross-attention K/V of a cross block over the (encoder or vision)
    context [B, S, D]."""
    b, s, _ = source.shape
    hd = cfg.resolved_head_dim
    pa = p_block["cross_attn"]
    src = source.to(COMPUTE_DTYPE)
    k = (src @ pa["wk"].to(COMPUTE_DTYPE)).reshape(b, s, cfg.n_kv_heads, hd)
    v = (src @ pa["wv"].to(COMPUTE_DTYPE)).reshape(b, s, cfg.n_kv_heads, hd)
    kpos = torch.arange(s, dtype=torch.int32, device=source.device)[None].expand(b, s)
    return AttnCache(k=k, v=v, kpos=kpos)


# ------------------------------------------------------------- cache makers
def init_cache_for_kind(cfg: ModelConfig, kind: str, batch: int, max_seq: int,
                        cross_len: int = 0, device=None) -> dict:
    """Empty decode caches of one block: a KV cache (a ring buffer of
    ``min(local_window, max_seq)`` for ``"local"``), MLA's latent cache, a
    cross cache of ``cross_len``, or a recurrent or RWKV state."""
    hd = cfg.resolved_head_dim

    def zeros(*shape, dtype=COMPUTE_DTYPE):
        return torch.zeros(shape, dtype=dtype, device=device)

    def kpos(n):
        return torch.full((batch, n), -1, dtype=torch.int32, device=device)

    def attn_cache(buf):
        return AttnCache(k=zeros(batch, buf, cfg.n_kv_heads, hd),
                         v=zeros(batch, buf, cfg.n_kv_heads, hd), kpos=kpos(buf))

    c: dict = {}
    if kind in ("attn", "cross"):
        if cfg.mla:
            c["self"] = MLACache(c_kv=zeros(batch, max_seq, cfg.kv_lora_rank),
                                 k_rope=zeros(batch, max_seq, cfg.qk_rope_head_dim),
                                 kpos=kpos(max_seq))
        else:
            c["self"] = attn_cache(max_seq)
        if kind == "cross":
            c["cross"] = attn_cache(cross_len)
    elif kind == "local":
        c["self"] = attn_cache(min(cfg.local_window, max_seq))
    elif kind == "rec":
        w = cfg.lru_width or cfg.d_model
        c["rec"] = RecState(h=zeros(batch, w, dtype=torch.float32),
                            conv=zeros(batch, cfg.conv_width - 1, w))
    elif kind == "rwkv":
        hk = cfg.rwkv_head_dim
        nh = cfg.d_model // hk
        c["rwkv"] = RwkvState(wkv=zeros(batch, nh, hk, hk, dtype=torch.float32),
                              shift_t=zeros(batch, cfg.d_model),
                              shift_c=zeros(batch, cfg.d_model))
    return c


def _layer_split(cfg: ModelConfig) -> tuple[int, int, int]:
    """(n_prefix, n_groups, n_tail): leading structurally different layers
    (deepseek's dense first layer), the stacked homogeneous groups, the
    non-divisible tail (recurrentgemma's 38 = 12 x 3 + 2)."""
    group = cfg.block_group
    prefix = cfg.first_dense_layers if cfg.n_experts else 0
    eff = cfg.n_layers - prefix
    n_groups = eff // len(group)
    return prefix, n_groups, eff - n_groups * len(group)


def _stack(trees: list):
    """Stack a list of equal cache trees (dicts of cache dataclasses) on a
    new leading axis."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _stack([t[k] for t in trees]) for k in t0}
    return type(t0)(*(torch.stack([getattr(t, f.name) for t in trees])
                      for f in dataclasses.fields(t0)))


def _at(tree, g: int):
    """Group g of a stacked params or cache tree (views: writes reach the
    stack)."""
    if isinstance(tree, dict):
        return {k: _at(v, g) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return type(tree)(*(getattr(tree, f.name)[g] for f in dataclasses.fields(tree)))
    return tree[g]


def _unbind(tree: dict, n: int) -> list[dict]:
    """The n groups of a stacked params tree, one ``torch.unbind`` a stack."""
    per = {k: _unbind(v, n) if isinstance(v, dict) else torch.unbind(v) for k, v in tree.items()}
    return [{k: per[k][g] for k in tree} for g in range(n)]


_SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_BY_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_contexts(cfg: ModelConfig):
    """The checkpoint's ``context_fn`` for ``cfg.remat_policy``."""
    if cfg.remat_policy == "dots":
        return lambda: create_selective_checkpoint_contexts(_save_dots)
    if cfg.remat_policy == "nothing":
        return noop_context_fn
    raise ConfigError(f"{cfg.name}: unknown remat_policy {cfg.remat_policy!r} "
                      "(\"nothing\" or \"dots\")")


def _requires_grad(tree) -> bool:
    if isinstance(tree, dict):
        return any(_requires_grad(v) for v in tree.values())
    return tree.requires_grad


def _train_block(p: Params, x: torch.Tensor, cfg: ModelConfig, kind: str, positions,
                 cross_source, encoder: bool = False):
    """One block in ``"train"`` mode: (x, aux), recomputed in the backward
    pass under ``cfg.remat`` when autograd records it."""
    def fn(p, x):
        y, _, aux = block_apply(p, x, cfg, kind, mode="train", positions=positions,
                                cross_source=cross_source, encoder=encoder)
        return y, aux

    graph = torch.is_grad_enabled() and (x.requires_grad or _requires_grad(p))
    if graph and cfg.remat:
        return checkpoint(fn, p, x, use_reentrant=False, preserve_rng_state=False,
                          context_fn=_remat_contexts(cfg))
    return fn(p, x)


def make_decode_caches(cfg: ModelConfig, batch: int, max_seq: int, cross_len: int = 0,
                       device=None) -> dict:
    """Cache tree: prefix list + stacked groups (one entry a group position)
    + tail list."""
    _stacked_only(cfg)
    group = cfg.block_group
    n_prefix, n_groups, n_tail = _layer_split(cfg)

    def one(kind):
        return init_cache_for_kind(cfg, kind, batch, max_seq, cross_len, device)

    grouped = {}
    for pos, kind in enumerate(group):
        grouped[f"pos{pos}"] = _stack([one(kind) for _ in range(n_groups)]) if n_groups else one(kind)
    return {"prefix": [one(_block_kind(cfg, i)) for i in range(n_prefix)], "groups": grouped,
            "tail": [one(_block_kind(cfg, i)) for i in range(n_tail)]}


# --------------------------------------------------------------- the model
def init_params(gen: torch.Generator, cfg: ModelConfig, device=None) -> Params:
    """Random params on ``device`` (default the generator's): the
    reference's keys, shapes, dtypes and distributions (embeddings
    N(0, 0.02), the head and every projection N(0, 1/fan_in), norms 1).
    ``device="meta"`` with a CPU generator gives the shapes and dtypes
    only, with nothing allocated."""
    _stacked_only(cfg)
    dev = _init_device(gen, device)
    pd = torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32
    vp = cfg.padded_vocab
    params: Params = {
        "embed": (torch.randn((vp, cfg.d_model), generator=gen, device=dev) * 0.02).to(pd),
        "ln_f": rmsnorm_init(cfg.d_model, cfg, dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = (torch.randn((cfg.d_model, vp), generator=gen, device=dev)
                          * (cfg.d_model**-0.5)).to(pd)
    group = cfg.block_group
    n_prefix, n_groups, n_tail = _layer_split(cfg)
    params["prefix"] = [block_init(gen, cfg, i, _block_kind(cfg, i), device=dev)
                        for i in range(n_prefix)]
    if n_groups:
        params["groups"] = {
            f"pos{p}": _stack_params([block_init(gen, cfg, n_prefix + g * len(group) + p, kind,
                                                 device=dev)
                                      for g in range(n_groups)])
            for p, kind in enumerate(group)
        }
    else:
        params["groups_list"] = []
    first_tail = n_prefix + n_groups * len(group)
    params["tail"] = [block_init(gen, cfg, first_tail + i, _block_kind(cfg, i), device=dev)
                      for i in range(n_tail)]
    if cfg.n_enc_layers:
        params["encoder"] = _stack_params([block_init(gen, cfg, i, "attn", encoder=True,
                                                      device=dev)
                                           for i in range(cfg.n_enc_layers)])
        params["enc_ln_f"] = rmsnorm_init(cfg.d_model, cfg, dev)
    return params


def _stack_params(trees: list[dict]) -> dict:
    """Stack per-layer param dicts into one dict of [G, ...] tensors,
    freeing each layer's tensors as they are copied."""
    out = {}
    for k in list(trees[0]):
        if isinstance(trees[0][k], dict):
            out[k] = _stack_params([t[k] for t in trees])
        else:
            out[k] = torch.stack([t.pop(k) for t in trees])
    return out


def apply_stack(
    params: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    mode: str,
    positions: torch.Tensor,
    caches: Optional[dict] = None,
    cache_index: Optional[int] = None,
    cross_source: Optional[torch.Tensor] = None,
):
    """Run the prefix blocks, the stacked groups (a loop over the group
    axis, each group's positions in order) and the tail.  Returns (x,
    caches, aux): prefill emits new caches, decode the given ones written
    in place, train None; aux is the float32 sum of the MoE aux losses."""
    _stacked_only(cfg)
    group = cfg.block_group
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    def run(p, kind, cache):
        nonlocal x, aux_total
        x, nc, aux = block_apply(p, x, cfg, kind, mode=mode, positions=positions, cache=cache,
                                 cache_index=cache_index, cross_source=cross_source)
        aux_total = aux_total + aux
        return nc

    new_prefix = [run(pp, _block_kind(cfg, i), caches["prefix"][i] if caches else None)
                  for i, pp in enumerate(params["prefix"])]
    new_groups: dict = {}
    if "groups" in params and mode == "train":
        n_groups = params["groups"]["pos0"]["ln1"].shape[0]
        stacks = [_unbind(params["groups"][f"pos{p}"], n_groups) for p in range(len(group))]
        for g in range(n_groups):
            for p, kind in enumerate(group):
                x, aux = _train_block(stacks[p][g], x, cfg, kind, positions, cross_source)
                aux_total = aux_total + aux
    elif "groups" in params:
        n_groups = params["groups"]["pos0"]["ln1"].shape[0]
        emitted: dict = {f"pos{p}": [] for p in range(len(group))}
        for g in range(n_groups):
            for p, kind in enumerate(group):
                gc = _at(caches["groups"][f"pos{p}"], g) if caches is not None else None
                nc = run(_at(params["groups"][f"pos{p}"], g), kind, gc)
                if mode == "prefill" and nc is not None:
                    emitted[f"pos{p}"].append(nc)
        if mode == "prefill":
            new_groups = {k: _stack(v) for k, v in emitted.items() if v}
        elif mode == "decode":
            new_groups = caches["groups"]
    new_tail = [run(tp, _block_kind(cfg, i), caches["tail"][i] if caches else None)
                for i, tp in enumerate(params["tail"])]
    out = None
    if mode in ("prefill", "decode"):
        out = {"prefix": new_prefix, "groups": new_groups, "tail": new_tail}
    return x, out, aux_total


def encode(params: Params, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The encoder stack over precomputed frontend embeddings [B, S, D]
    (bidirectional attention), then its final norm."""
    x = frames
    b, s = frames.shape[:2]
    positions = torch.arange(s, dtype=torch.int32, device=frames.device)[None].expand(b, s)
    enc = params["encoder"]
    for p in _unbind(enc, enc["ln1"].shape[0]):
        x, _ = _train_block(p, x, cfg, "attn", positions, None, encoder=True)
    return rmsnorm(x, params["enc_ln_f"], cfg.norm_eps)


def embed_tokens(params: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"][tokens].to(COMPUTE_DTYPE)


def logits_from(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = rmsnorm(x, params["ln_f"], cfg.norm_eps).to(COMPUTE_DTYPE)
    if cfg.tie_embeddings:
        w = params["embed"].to(COMPUTE_DTYPE).T
    else:
        w = params["head"].to(COMPUTE_DTYPE)
    return h @ w
