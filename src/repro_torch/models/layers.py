"""Model layers in PyTorch, counterpart of ``repro.models.layers``: the
dense family's norms, RoPE, grouped-query attention and SwiGLU MLP, and the
decode-time cache containers.

Functional style as in the reference: ``*_init(gen, cfg)`` returns a params
dict with the reference pytree's keys and shapes, and the apply functions
are plain functions on tensors.  Activations are bf16, softmax and norm
statistics float32.  Random init draws the reference's distributions from
an explicit ``torch.Generator`` on the target device (not its numbers:
tests convert the reference's params instead).

Causal self-attention in the ``"train"`` and ``"prefill"`` modes goes
through the flash-attention wrapper (``kernels.ops.flash_attention``), whose
probabilities are float32 (the plain version, on the CPU) or float32 carried
as two bf16 terms, hi and lo, about 16 bits (the bf16 kernel on the card);
every other case (decode, the local mask, ``"none"``, cross-attention,
``attn_softmax_bf16``) goes through the ported ``_sdpa``, which rounds the
probabilities once to bf16 before ``p @ v``, as the reference does
everywhere.  The two routes differ by that rounding.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..configs.base import ModelConfig
from ..kernels import ops

__all__ = [
    "AttnCache",
    "COMPUTE_DTYPE",
    "MLACache",
    "attention_apply",
    "attention_init",
    "dense_init",
    "mlp_apply",
    "mlp_init",
    "rmsnorm",
    "rmsnorm_init",
    "rope",
]

Params = dict
COMPUTE_DTYPE = torch.bfloat16
_NEG = -1e30


def _pdtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, cfg: ModelConfig,
               scale: float = 1.0) -> torch.Tensor:
    std = scale / (in_dim**0.5)
    w = torch.randn((in_dim, out_dim), generator=gen, device=gen.device, dtype=torch.float32)
    return (w * std).to(_pdtype(cfg))


def rmsnorm_init(dim: int, cfg: ModelConfig, device=None) -> torch.Tensor:
    return torch.ones((dim,), dtype=_pdtype(cfg), device=device)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale.to(x.dtype)


# --------------------------------------------------------------------- RoPE
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x[..., S, H, D]; positions[..., S] (int).  Rotates pairs (d, d+D/2)."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    angles = positions[..., :, None].float() * freqs  # [..., S, half]
    cos = torch.cos(angles)[..., None, :].to(x.dtype)  # [..., S, 1, half]
    sin = torch.sin(angles)[..., None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ---------------------------------------------------------------- attention
@dataclasses.dataclass
class AttnCache:
    """Decode-time KV cache.  k/v: [B, S_buf, KV, D]; kpos: [B, S_buf]
    absolute positions (-1 = empty).  Stacked layer groups carry a leading
    group axis: [G, B, S_buf, KV, D] and [G, B, S_buf]."""

    k: torch.Tensor
    v: torch.Tensor
    kpos: torch.Tensor


@dataclasses.dataclass
class MLACache:
    """MLA latent cache: c_kv [B, S, lora] + k_rope [B, S, rope_dim]."""

    c_kv: torch.Tensor
    k_rope: torch.Tensor
    kpos: torch.Tensor


def attention_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    p = {
        "wq": dense_init(gen, d, cfg.n_heads * hd, cfg),
        "wk": dense_init(gen, d, cfg.n_kv_heads * hd, cfg),
        "wv": dense_init(gen, d, cfg.n_kv_heads * hd, cfg),
        "wo": dense_init(gen, cfg.n_heads * hd, d, cfg),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, cfg, gen.device)
        p["k_norm"] = rmsnorm_init(hd, cfg, gen.device)
    return p


def _softmax(s: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax``'s ops over the last axis: exp(s - max) in s's
    dtype, its sum in float32 rounded to s's dtype, then the division
    (``torch.softmax`` rounds once, which differs in bf16)."""
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.float().sum(dim=-1, keepdim=True).to(s.dtype)


def _sdpa(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Sk, KV, D]
    v: torch.Tensor,
    mask: Optional[torch.Tensor],  # [B, 1|H, Sq, Sk] additive or None
    q_chunk: int = 1024,
    softmax_bf16: bool = False,
) -> torch.Tensor:
    """Softmax attention chunked over Sq (the score buffer is at most
    [B, H, q_chunk, Sk]); one decode token with GQA contracts against the
    raw KV heads, with no repeat."""
    b, sq, h, d = q.shape
    kv = k.shape[2]
    rep = h // kv
    scale = d**-0.5
    if sq == 1 and rep > 1:
        qg = q.reshape(b, sq, kv, rep, d)
        s = torch.einsum("bckrd,bskd->bkrcs", qg, k).float() * scale
        if mask is not None:
            s = s + mask[:, None]  # [B, 1|H -> 1, 1, C, S] over (kv, rep)
        p = _softmax(s).to(q.dtype)
        out = torch.einsum("bkrcs,bskd->bckrd", p, v)
        return out.reshape(b, sq, h, d)
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)

    def one_chunk(qc, mc):
        # qc [B, C, H, D]; mc [B, 1|H, C, Sk] or None
        acc = torch.bfloat16 if softmax_bf16 else torch.float32
        s = torch.einsum("bchd,bkhd->bhck", qc, k).to(acc) * torch.tensor(
            scale, dtype=acc, device=qc.device)
        if mc is not None:
            s = s + mc.to(s.dtype)
        p = _softmax(s).to(qc.dtype)
        return torch.einsum("bhck,bkhd->bchd", p, v)

    if sq <= q_chunk:
        return one_chunk(q, mask)
    n_chunks = sq // q_chunk
    assert sq % q_chunk == 0, f"Sq={sq} % chunk={q_chunk}"
    outs = []
    for c in range(n_chunks):
        sl = slice(c * q_chunk, (c + 1) * q_chunk)
        outs.append(one_chunk(q[:, sl], None if mask is None else mask[:, :, sl]))
    return torch.cat(outs, dim=1)


def _causal_mask(sq: int, sk: int, device=None) -> torch.Tensor:
    """Additive float32 mask [1, 1, Sq, Sk]: 0 where kpos <= qpos, else -1e30."""
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    return torch.where(kpos <= qpos, 0.0, _NEG)[None, None]


def _local_mask(sq: int, sk: int, window: int, device=None) -> torch.Tensor:
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    ok = (kpos <= qpos) & (qpos - kpos < window)
    return torch.where(ok, 0.0, _NEG)[None, None]


def attention_apply(
    p: Params,
    x: torch.Tensor,  # [B, S, D]
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,  # [B, S]
    mode: str,  # "train" | "prefill" | "decode" | "decode_cross"
    mask_kind: str = "causal",  # "causal" | "local" | "none" (encoder)
    cache: Optional[AttnCache] = None,
    cache_index: Optional[int] = None,
    kv_source: Optional[torch.Tensor] = None,  # cross-attention context
    window: int = 0,
) -> tuple[torch.Tensor, Optional[AttnCache]]:
    """Returns (out [B, S, D] in x's dtype, cache).  ``"decode"`` writes the
    step's K, V and position into ``cache`` in place at ``cache_index``
    (clamped into the buffer as ``dynamic_update_slice`` clamps it; a local
    buffer wraps) and returns it; ``"prefill"`` returns a new cache."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    xc = x.to(COMPUTE_DTYPE)
    q = (xc @ p["wq"].to(COMPUTE_DTYPE)).reshape(b, s, cfg.n_heads, hd)
    is_cross = (kv_source is not None) or mode == "decode_cross"
    if mode == "decode_cross":
        # static cross context: K/V live in the (prefill-built) cache
        assert cache is not None
        k = cache.k.to(COMPUTE_DTYPE)
        v = cache.v.to(COMPUTE_DTYPE)
        sk_in = k.shape[1]
    else:
        src = kv_source.to(COMPUTE_DTYPE) if kv_source is not None else xc
        sk_in = src.shape[1]
        k = (src @ p["wk"].to(COMPUTE_DTYPE)).reshape(b, sk_in, cfg.n_kv_heads, hd)
        v = (src @ p["wv"].to(COMPUTE_DTYPE)).reshape(b, sk_in, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        if mode != "decode_cross":
            k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if not is_cross:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    new_cache = None
    mask = None
    flash = False
    if mode == "decode" and not is_cross:
        assert cache is not None and cache_index is not None
        buf = cache.k.shape[1]
        slot = (int(cache_index) % buf) if mask_kind == "local" else int(cache_index)
        if cfg.masked_cache_update:
            # one-hot masked write: a slot past the buffer writes nothing
            oh = torch.arange(buf, device=x.device) == slot
            ohk = oh[None, :, None, None]
            cache.k.copy_(torch.where(ohk, k.to(cache.k.dtype), cache.k))
            cache.v.copy_(torch.where(ohk, v.to(cache.v.dtype), cache.v))
            cache.kpos.copy_(torch.where(oh[None, :], positions.to(cache.kpos.dtype), cache.kpos))
        else:
            slot = min(max(slot, 0), buf - 1)  # dynamic_update_slice clamps the start
            cache.k[:, slot : slot + 1] = k.to(cache.k.dtype)
            cache.v[:, slot : slot + 1] = v.to(cache.v.dtype)
            cache.kpos[:, slot : slot + 1] = positions.to(cache.kpos.dtype)
        new_cache = cache
        k, v = cache.k.to(COMPUTE_DTYPE), cache.v.to(COMPUTE_DTYPE)
        qpos = positions[:, :, None]  # [B, 1, 1]
        kp = cache.kpos[:, None, :]  # [B, 1, S_buf]
        ok = (kp >= 0) & (kp <= qpos)
        if mask_kind == "local":
            ok &= (qpos - kp) < window
        mask = torch.where(ok, 0.0, _NEG)[:, None]  # [B, 1, 1, S_buf] float32
    elif mode == "decode_cross":
        mask = torch.where(cache.kpos[:, None, None, :] >= 0, 0.0, _NEG)
    elif is_cross or mask_kind == "none":
        mask = None
    elif mask_kind == "local":
        mask = _local_mask(s, sk_in, window, device=x.device)
    elif cfg.attn_softmax_bf16:
        mask = _causal_mask(s, sk_in, device=x.device)
    else:
        flash = True  # causal self-attention over the whole sequence

    if flash:
        y = ops.flash_attention(q, k, v, causal=True)
    else:
        y = _sdpa(q, k, v, mask, softmax_bf16=cfg.attn_softmax_bf16)
    out = (y.reshape(b, s, cfg.n_heads * hd) @ p["wo"].to(COMPUTE_DTYPE)).to(x.dtype)
    if mode == "prefill":
        if is_cross:
            kpos = torch.arange(sk_in, dtype=torch.int32, device=x.device)[None].expand(b, sk_in)
        else:
            kpos = positions.to(torch.int32)
        new_cache = AttnCache(k=k.to(COMPUTE_DTYPE), v=v.to(COMPUTE_DTYPE), kpos=kpos)
    return out, new_cache


# --------------------------------------------------------------------- MLPs
def mlp_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "wg": dense_init(gen, d, ff, cfg),
        "wu": dense_init(gen, d, ff, cfg),
        "wd": dense_init(gen, ff, d, cfg),
    }


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``'s ops, x * (1 / (1 + exp(-x))), each rounded to x's
    dtype (``F.silu`` rounds once and differs in the last bf16 bit)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def mlp_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    xc = x.to(COMPUTE_DTYPE)
    h = _silu(xc @ p["wg"].to(COMPUTE_DTYPE)) * (xc @ p["wu"].to(COMPUTE_DTYPE))
    return (h @ p["wd"].to(COMPUTE_DTYPE)).to(x.dtype)
