"""Decoder-only transformer assembly in PyTorch, counterpart of
``repro.models.transformer`` for the dense family.

Layers are grouped into the smallest repeating pattern
(``cfg.block_group``, ``("attn",)`` for the dense archs) and the group
params are stacked on a leading ``[G, ...]`` axis, as the reference stacks
them for ``lax.scan``; a Python loop over that axis takes the scan's place.
Prefill emits the caches stacked the same way, and decode writes into the
stacked caches in place.  The other block kinds (MLA, MoE, RG-LRU, RWKV,
cross-attention) come with models slice B (ROADMAP queue 1 item 3).

Modes: ``"train"`` (no caches), ``"prefill"`` (emit caches), ``"decode"``
(one token step against caches).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ModelConfig
from .layers import (
    COMPUTE_DTYPE,
    AttnCache,
    attention_apply,
    attention_init,
    mlp_apply,
    mlp_init,
    rmsnorm,
    rmsnorm_init,
)

__all__ = [
    "apply_stack",
    "block_apply",
    "block_init",
    "embed_tokens",
    "init_cache_for_kind",
    "init_params",
    "logits_from",
    "make_decode_caches",
]

Params = dict
_LATER = "models slice B (ROADMAP queue 1 item 3)"


def _dense_only(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.block_group != ("attn",) or cfg.n_experts or cfg.mla:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} comes with {_LATER}; the port runs dense models")
    if not cfg.scan_blocks:
        raise NotImplementedError(f"{cfg.name}: the port stacks its layer groups (scan_blocks)")


# ------------------------------------------------------------ block structs
def _block_kind(cfg: ModelConfig, layer_idx: int) -> str:
    return cfg.block_group[layer_idx % len(cfg.block_group)]


def block_init(gen: torch.Generator, cfg: ModelConfig, layer_idx: int, kind: str) -> Params:
    if kind != "attn":
        raise NotImplementedError(f"block kind {kind!r} comes with {_LATER}")
    return {
        "ln1": rmsnorm_init(cfg.d_model, cfg, gen.device),
        "ln2": rmsnorm_init(cfg.d_model, cfg, gen.device),
        "attn": attention_init(gen, cfg),
        "mlp": mlp_init(gen, cfg),
    }


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
) -> tuple[torch.Tensor, Optional[dict]]:
    """Attention then MLP, each behind an RMSNorm and a residual.  Returns
    (x, new cache dict or None)."""
    if kind != "attn":
        raise NotImplementedError(f"block kind {kind!r} comes with {_LATER}")
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    y, c = attention_apply(
        p["attn"], h, cfg, positions=positions, mode=mode, mask_kind="causal",
        cache=cache.get("self") if cache else None, cache_index=cache_index,
        window=cfg.local_window,
    )
    x = x + y
    h2 = rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + mlp_apply(p["mlp"], h2), ({"self": c} if c is not None else None)


# ------------------------------------------------------------- cache makers
def init_cache_for_kind(cfg: ModelConfig, kind: str, batch: int, max_seq: int,
                        device=None) -> dict:
    if kind != "attn" or cfg.mla:
        raise NotImplementedError(f"caches of kind {kind!r} come with {_LATER}")
    hd = cfg.resolved_head_dim
    shape = (batch, max_seq, cfg.n_kv_heads, hd)
    return {"self": AttnCache(
        k=torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device),
        v=torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device),
        kpos=torch.full((batch, max_seq), -1, dtype=torch.int32, device=device),
    )}


def _layer_split(cfg: ModelConfig) -> tuple[int, int, int]:
    """(n_prefix, n_groups, n_tail): leading structurally different layers,
    the stacked homogeneous groups, the non-divisible tail."""
    group = cfg.block_group
    prefix = cfg.first_dense_layers if cfg.n_experts else 0
    eff = cfg.n_layers - prefix
    n_groups = eff // len(group)
    return prefix, n_groups, eff - n_groups * len(group)


def _stack(trees: list):
    """Stack a list of equal cache trees (dicts of AttnCaches) on a new
    leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return AttnCache(*(torch.stack([getattr(t, f) for t in trees]) for f in ("k", "v", "kpos")))


def _at(tree, g: int):
    """Group g of a stacked params or cache tree (views: writes reach the
    stack)."""
    if isinstance(tree, dict):
        return {k: _at(v, g) for k, v in tree.items()}
    if isinstance(tree, AttnCache):
        return AttnCache(tree.k[g], tree.v[g], tree.kpos[g])
    return tree[g]


def make_decode_caches(cfg: ModelConfig, batch: int, max_seq: int, device=None) -> dict:
    """Cache tree: prefix list + stacked groups + tail list."""
    _dense_only(cfg)
    _, n_groups, _ = _layer_split(cfg)
    one = init_cache_for_kind(cfg, "attn", batch, max_seq, device)
    return {"prefix": [], "groups": {"pos0": _stack([one] * n_groups)}, "tail": []}


# --------------------------------------------------------------- the model
def init_params(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random params on the generator's device: the reference's keys,
    shapes, dtypes and distributions (embeddings N(0, 0.02), the head and
    every projection N(0, 1/fan_in), norms 1)."""
    _dense_only(cfg)
    dev = gen.device
    pd = torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32
    vp = cfg.padded_vocab
    params: Params = {
        "embed": (torch.randn((vp, cfg.d_model), generator=gen, device=dev) * 0.02).to(pd),
        "ln_f": rmsnorm_init(cfg.d_model, cfg, dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = (torch.randn((cfg.d_model, vp), generator=gen, device=dev)
                          * (cfg.d_model**-0.5)).to(pd)
    _, n_groups, _ = _layer_split(cfg)
    params["prefix"] = []
    layers = [block_init(gen, cfg, g, _block_kind(cfg, g)) for g in range(n_groups)]
    params["groups"] = {"pos0": _stack_params(layers)}
    params["tail"] = []
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
):
    """Run the stacked groups (a loop over the group axis).  Returns
    (x, caches): prefill emits new stacked caches, decode the given ones
    written in place, train None."""
    _dense_only(cfg)
    groups = params["groups"]["pos0"]
    n_groups = groups["ln1"].shape[0]
    emitted = []
    for g in range(n_groups):
        gc = _at(caches["groups"]["pos0"], g) if caches is not None else None
        x, nc = block_apply(_at(groups, g), x, cfg, _block_kind(cfg, g), mode=mode,
                            positions=positions, cache=gc, cache_index=cache_index)
        if mode == "prefill":
            emitted.append(nc)
    if mode == "prefill":
        return x, {"prefix": [], "groups": {"pos0": _stack(emitted)}, "tail": []}
    if mode == "decode":
        return x, caches
    return x, None


def embed_tokens(params: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"][tokens].to(COMPUTE_DTYPE)


def logits_from(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = rmsnorm(x, params["ln_f"], cfg.norm_eps).to(COMPUTE_DTYPE)
    if cfg.tie_embeddings:
        w = params["embed"].to(COMPUTE_DTYPE).T
    else:
        w = params["head"].to(COMPUTE_DTYPE)
    return h @ w
