"""Model layers in PyTorch, counterpart of ``repro.models.layers``: norms,
RoPE, grouped-query, local and cross attention, MLA (latent KV, absorbed
decode), the SwiGLU MLP, the Switch/GShard MoE with shared experts, RG-LRU
and RWKV6, and the decode-time cache and state containers.

Functional style as in the reference: ``*_init(gen, cfg)`` returns a params
dict with the reference pytree's keys and shapes, and the apply functions
are plain functions on tensors.  Activations are bf16, softmax and norm
statistics float32.  Random init draws the reference's distributions from
an explicit ``torch.Generator`` (not its numbers: tests convert the
reference's params instead) onto the generator's device, or onto
``device`` where an init is given one (``"meta"``: shapes and dtypes only,
from a CPU generator).

Causal self-attention in the ``"train"`` and ``"prefill"`` modes goes
through the flash-attention wrapper (``kernels.ops.flash_attention``), whose
probabilities are float32 (the plain version, on the CPU) or float32 carried
as two bf16 terms, hi and lo, about 16 bits (the bf16 kernel on the card);
every other case (decode, the local mask, ``"none"``, cross-attention,
``attn_softmax_bf16``) goes through the ported ``_sdpa``, which rounds the
probabilities once to bf16 before ``p @ v``, as the reference does
everywhere.  The two routes differ by that rounding.  MLA's expanded
prefill takes the same flash route at head dim nope + rope, with V padded
with zeros to that width (the kernel wants k and v of one shape) and the
output cut back; its absorbed decode stays in the latent space as the
reference's does.

The MoE keeps the reference's single-device dispatch (top-k by a stable
sort, so ties take the lower expert as ``lax.top_k`` does; a capacity in
Python floats; positions from a one-hot cumsum; an ``[E, cap, d]`` buffer),
writes only the kept rows of that buffer and adds each token's k
contributions in slot order in bf16, so the card's sum has one order
(``index_add_`` on the card adds by atomics, in no fixed order).  Under
the rules of a mesh with a ``"model"`` axis, a ``moe_ep`` config takes the
reference's expert-parallel route: each model rank dispatches every token
to its own experts only, and one all_reduce over the model group sums the
ranks' outputs (bit-equal to the single-device MoE on one rank).  The
RG-LRU scan is ``lax.associative_scan``'s recursion (pair neighbours, scan
the pairs, fill in the even elements), so its products and sums are the
reference's, bit for bit.  Decode writes recurrent and RWKV states in
place, as it writes the KV caches.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..configs.base import ModelConfig
from ..kernels import ops
from ..parallel.sharding import current_rules, mesh_axes

__all__ = [
    "AttnCache",
    "COMPUTE_DTYPE",
    "MLACache",
    "RecState",
    "RwkvState",
    "attention_apply",
    "attention_init",
    "dense_init",
    "mla_apply",
    "mla_init",
    "mlp_apply",
    "mlp_init",
    "moe_apply",
    "moe_init",
    "rglru_apply",
    "rglru_init",
    "rmsnorm",
    "rmsnorm_init",
    "rope",
    "rwkv_apply",
    "rwkv_init",
]

Params = dict
COMPUTE_DTYPE = torch.bfloat16
_NEG = -1e30


def _pdtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32


def _init_device(gen: torch.Generator, device) -> torch.device:
    """Where an init puts its params: ``device``, else the generator's."""
    return gen.device if device is None else torch.device(device)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, cfg: ModelConfig,
               scale: float = 1.0, device=None) -> torch.Tensor:
    std = scale / (in_dim**0.5)
    w = torch.randn((in_dim, out_dim), generator=gen, device=_init_device(gen, device),
                    dtype=torch.float32)
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


def attention_init(gen: torch.Generator, cfg: ModelConfig, cross: bool = False,
                   device=None) -> Params:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    p = {
        "wq": dense_init(gen, d, cfg.n_heads * hd, cfg, device=device),
        "wk": dense_init(gen, d, cfg.n_kv_heads * hd, cfg, device=device),
        "wv": dense_init(gen, d, cfg.n_kv_heads * hd, cfg, device=device),
        "wo": dense_init(gen, cfg.n_heads * hd, d, cfg, device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, cfg, _init_device(gen, device))
        p["k_norm"] = rmsnorm_init(hd, cfg, _init_device(gen, device))
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


def _write_step(buf: torch.Tensor, new: torch.Tensor, slot: int, masked: bool) -> None:
    """Write one step ``new`` [B, 1, ...] into ``buf`` [B, S_buf, ...] at
    ``slot``, in place: a one-hot masked select (a slot past the buffer
    writes nothing) or ``dynamic_update_slice``'s write, which clamps the
    slot into the buffer."""
    n = buf.shape[1]
    if masked:
        oh = (torch.arange(n, device=buf.device) == slot).reshape((1, n) + (1,) * (buf.ndim - 2))
        buf.copy_(torch.where(oh, new.to(buf.dtype), buf))
    else:
        slot = min(max(slot, 0), n - 1)
        buf[:, slot : slot + 1] = new.to(buf.dtype)


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
        slot = int(cache_index)
        if mask_kind == "local":
            slot %= cache.k.shape[1]
        for buf_t, new_t in ((cache.k, k), (cache.v, v), (cache.kpos, positions)):
            _write_step(buf_t, new_t, slot, cfg.masked_cache_update)
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


# --------------------------------------------------------------------- MLA
def mla_init(gen: torch.Generator, cfg: ModelConfig, device=None) -> Params:
    d, h = cfg.d_model, cfg.n_heads
    nd, rd, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {
        "wq": dense_init(gen, d, h * (nd + rd), cfg, device=device),
        "w_dkv": dense_init(gen, d, cfg.kv_lora_rank, cfg, device=device),
        "w_krope": dense_init(gen, d, rd, cfg, device=device),
        "w_kup": dense_init(gen, cfg.kv_lora_rank, h * nd, cfg, device=device),
        "w_vup": dense_init(gen, cfg.kv_lora_rank, h * vd, cfg, device=device),
        "wo": dense_init(gen, h * vd, d, cfg, device=device),
        "kv_norm": rmsnorm_init(cfg.kv_lora_rank, cfg, _init_device(gen, device)),
    }


def mla_apply(
    p: Params,
    x: torch.Tensor,  # [B, S, D]
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,  # [B, S]
    mode: str,  # "train" | "prefill" | "decode"
    cache: Optional[MLACache] = None,
    cache_index: Optional[int] = None,
) -> tuple[torch.Tensor, Optional[MLACache]]:
    """Multi-head latent attention.  ``"decode"`` writes the step's latent,
    rope key and position into ``cache`` in place and attends in the latent
    space (q_nope absorbed through W_kup, the context expanded once through
    W_vup); train and prefill expand K and V per head and run causal
    self-attention at head dim nope + rope (the flash kernel, V padded to
    that width; ``_sdpa`` under ``attn_softmax_bf16``, with the float32
    softmax the reference's MLA always takes)."""
    b, s, _ = x.shape
    h = cfg.n_heads
    nd, rd, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    xc = x.to(COMPUTE_DTYPE)
    q = (xc @ p["wq"].to(COMPUTE_DTYPE)).reshape(b, s, h, nd + rd)
    q_nope, q_rope = q[..., :nd], q[..., nd:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)
    c_kv = rmsnorm(xc @ p["w_dkv"].to(COMPUTE_DTYPE), p["kv_norm"], cfg.norm_eps)
    k_rope_new = rope((xc @ p["w_krope"].to(COMPUTE_DTYPE))[:, :, None, :], positions,
                      cfg.rope_theta)[:, :, 0, :]

    new_cache = None
    if mode == "decode":
        assert cache is not None and cache_index is not None
        for buf_t, new_t in ((cache.c_kv, c_kv), (cache.k_rope, k_rope_new),
                             (cache.kpos, positions)):
            _write_step(buf_t, new_t, int(cache_index), cfg.masked_cache_update)
        new_cache = cache
        ck, cr = cache.c_kv.to(COMPUTE_DTYPE), cache.k_rope.to(COMPUTE_DTYPE)
        w_kup = p["w_kup"].to(COMPUTE_DTYPE).reshape(-1, h, nd)  # [lora, H, nd]
        q_lat = torch.einsum("bshn,lhn->bshl", q_nope, w_kup)  # [B, 1, H, lora]
        s_lat = torch.einsum("bshl,bkl->bhsk", q_lat, ck)
        s_rope = torch.einsum("bshr,bkr->bhsk", q_rope, cr)
        scores = (s_lat + s_rope).float() * ((nd + rd) ** -0.5)
        kp = cache.kpos[:, None, None, :]  # [B, 1, 1, Sk]
        qp = positions[:, None, :, None]  # [B, 1, Sq, 1]
        scores = torch.where((kp >= 0) & (kp <= qp), scores, _NEG)
        probs = _softmax(scores).to(COMPUTE_DTYPE)
        ctx_lat = torch.einsum("bhsk,bkl->bshl", probs, ck)
        w_vup = p["w_vup"].to(COMPUTE_DTYPE).reshape(-1, h, vd)
        ctx = torch.einsum("bshl,lhv->bshv", ctx_lat, w_vup)
    else:
        k_nope = (c_kv @ p["w_kup"].to(COMPUTE_DTYPE)).reshape(b, s, h, nd)
        vv = (c_kv @ p["w_vup"].to(COMPUTE_DTYPE)).reshape(b, s, h, vd)
        qq = torch.cat([q_nope, q_rope], dim=-1)
        kk = torch.cat([k_nope, k_rope_new[:, :, None, :].expand(b, s, h, rd)], dim=-1)
        if cfg.attn_softmax_bf16:
            ctx = _sdpa(qq, kk, vv, _causal_mask(s, s, device=x.device))
        else:
            if vd > nd + rd:
                raise ValueError(f"MLA: v_head_dim {vd} exceeds the q/k head dim {nd + rd}")
            v_pad = F.pad(vv, (0, nd + rd - vd))  # zero columns change no other column
            ctx = ops.flash_attention(qq, kk, v_pad, causal=True)[..., :vd]
        if mode == "prefill":
            new_cache = MLACache(c_kv=c_kv.to(COMPUTE_DTYPE), k_rope=k_rope_new.to(COMPUTE_DTYPE),
                                 kpos=positions.to(torch.int32))
    out = (ctx.reshape(b, s, h * vd) @ p["wo"].to(COMPUTE_DTYPE)).to(x.dtype)
    return out, new_cache


# --------------------------------------------------------------------- MLPs
def mlp_init(gen: torch.Generator, cfg: ModelConfig, d_ff: Optional[int] = None,
             device=None) -> Params:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    return {
        "wg": dense_init(gen, d, ff, cfg, device=device),
        "wu": dense_init(gen, d, ff, cfg, device=device),
        "wd": dense_init(gen, ff, d, cfg, device=device),
    }


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``'s ops, x * (1 / (1 + exp(-x))), each rounded to x's
    dtype (``F.silu`` rounds once and differs in the last bf16 bit)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def mlp_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    xc = x.to(COMPUTE_DTYPE)
    h = _silu(xc @ p["wg"].to(COMPUTE_DTYPE)) * (xc @ p["wu"].to(COMPUTE_DTYPE))
    return (h @ p["wd"].to(COMPUTE_DTYPE)).to(x.dtype)


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` (``lax.logistic``): in bf16 its ops one by one,
    1 / (1 + exp(-x)), each rounded to bf16 as XLA expands it; in float32
    ``torch.sigmoid``, the nearer of the two there."""
    if x.dtype == torch.bfloat16:
        return 1.0 / (1.0 + torch.exp(-x))
    return torch.sigmoid(x)


# --------------------------------------------------------------------- MoE
def _expert_normal(gen: torch.Generator, shape: tuple, std: float, cfg: ModelConfig,
                   device=None) -> torch.Tensor:
    """N(0, std) expert weights [E, ...] in the param dtype, drawn an expert
    at a time, so the float32 draw is one expert's, not the whole tensor's
    (on meta, which holds no values, the empty tensor)."""
    dev = _init_device(gen, device)
    out = torch.empty(shape, dtype=_pdtype(cfg), device=dev)
    for e in range(0 if dev.type == "meta" else shape[0]):
        w = torch.randn(shape[1:], generator=gen, device=dev, dtype=torch.float32)
        out[e] = (w * std).to(out.dtype)
    return out


def moe_init(gen: torch.Generator, cfg: ModelConfig, device=None) -> Params:
    d, ff, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    p = {
        "router": dense_init(gen, d, e, cfg, scale=0.1, device=device),
        "wg": _expert_normal(gen, (e, d, ff), 1.0 / (d**0.5), cfg, device),
        "wu": _expert_normal(gen, (e, d, ff), 1.0 / (d**0.5), cfg, device),
        "wd": _expert_normal(gen, (e, ff, d), ff**-0.5, cfg, device),
    }
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(gen, cfg, d_ff=cfg.moe_d_ff * cfg.n_shared_experts,
                               device=device)
    return p


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """int64 one-hot rows of ``idx`` (``F.one_hot``'s values): one
    comparison, the same ops on every device (``F.one_hot`` checks the
    values on the host on the CPU and scatters on the card), so the dry
    run's count on meta is the card's."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).long()


def _route(p: Params, xt: torch.Tensor, cfg: ModelConfig) -> tuple:
    """Top-k routing of the tokens xt [T, d]: (float32 router probabilities
    [T, E], the gates [T, k] normalized over the k, the experts [T, k])."""
    # bf16 @ float32 promotes to a float32 product in the reference
    probs = _softmax(xt.float() @ p["router"].float())
    # top-k by a stable descending sort: ties take the lower expert first
    gate_vals, expert_idx = (t[:, : cfg.top_k] for t in torch.sort(
        probs, dim=-1, descending=True, stable=True))
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    return probs, gate_vals, expert_idx


def _local_experts(w: torch.Tensor, first: int, count: int) -> torch.Tensor:
    """Experts first .. first + count - 1 of an expert-stacked weight: a
    DTensor's local piece, or a slice of the whole weight."""
    if isinstance(w, DTensor):
        w = w.redistribute(w.device_mesh, [Shard(0) if n == "model" else Replicate()
                                           for n in w.device_mesh.mesh_dim_names]).to_local()
        if w.shape[0] != count:
            raise ValueError(f"expert-parallel weight: {w.shape[0]} local experts, not {count}")
        return w
    return w if w.shape[0] == count else w.narrow(0, first, count)


def _moe_experts(p: Params, xt: torch.Tensor, cfg: ModelConfig, expert_idx: torch.Tensor,
                 gate_vals: torch.Tensor, first: int, count: int) -> torch.Tensor:
    """Experts first .. first + count - 1 on the tokens xt [T, d]: the
    capacity dispatch into [count, cap, d], the expert matmuls, each token's
    k gated contributions (zero from the other experts) added in slot order
    in bf16.  All experts (first 0, count E) is the single-device MoE."""
    n_tok, d = xt.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = max(8, int(cfg.capacity_factor * n_tok * k / e))

    # position of each (token, slot) within its expert, by a one-hot cumsum;
    # the one-hot is [count, T*k] so the scan runs along its contiguous last
    # axis (CUDA torch scans an outer axis column by column, serially)
    eidx = expert_idx.reshape(-1) - first  # [T*k], in [0, count) iff this rank's
    if count == e:
        mine = None
        onehot = _one_hot(eidx, e).T.contiguous()
    else:
        mine = (eidx >= 0) & (eidx < count)
        eidx = torch.clamp(eidx, 0, count - 1)
        onehot = (_one_hot(eidx, count) * mine[:, None]).T.contiguous()
    pos = ((torch.cumsum(onehot, dim=1) - 1) * onehot).sum(0)
    keep = pos < cap if mine is None else mine & (pos < cap)
    gates = (gate_vals.reshape(-1) * keep).to(COMPUTE_DTYPE)
    token_src = torch.arange(n_tok, device=xt.device).repeat_interleave(k)
    safe_pos = torch.where(keep, pos, cap - 1)

    # dispatch into [count, cap, d]: the kept rows, each once; a dropped row
    # goes to a scratch slot (cap) that is never read
    buf = torch.zeros((count, cap + 1, d), dtype=COMPUTE_DTYPE, device=xt.device)
    buf.view(count * (cap + 1), d)[eidx * (cap + 1) + torch.where(keep, pos, cap)] = xt[token_src]
    buf = buf[:, :cap]
    wg, wu, wd = (_local_experts(p[n], first, count).to(COMPUTE_DTYPE) for n in ("wg", "wu", "wd"))
    h = _silu(torch.bmm(buf, wg)) * torch.bmm(buf, wu)
    yb = torch.bmm(h, wd)  # [count, cap, d]

    # gather back: each token's k gated contributions added in slot order
    contrib = (yb[eidx, safe_pos] * gates[:, None]).reshape(n_tok, k, d)
    y = torch.zeros((n_tok, d), dtype=COMPUTE_DTYPE, device=xt.device)
    for j in range(k):
        y = y + contrib[:, j]
    return y


def _moe_apply_ep(p: Params, x: torch.Tensor, cfg: ModelConfig, rules) -> tuple:
    """Expert-parallel MoE (the reference's replicated-dispatch
    ``_moe_apply_ep``): the tokens are replicated over the ``"model"`` axis,
    so each model rank routes every token, runs the tokens routed to its
    E / msize experts (its capacity the single device's), and one bf16
    all_reduce over the model group sums the ranks' [T, d] partial outputs.
    Expert weights are a DTensor split over ``"model"`` on dim 0 or the
    whole [E, ...] weight (each rank reads its experts).  Over more than
    one model rank it runs forward only (prefill, decode): the all_reduce
    is outside autograd, so it raises where a gradient is being recorded."""
    b, s, d = x.shape
    e = cfg.n_experts
    msize = mesh_axes(rules.mesh).get("model", 1)
    count = e // msize
    mrank = 0
    if msize > 1:
        if torch.is_grad_enabled() and (x.requires_grad or any(
                t.requires_grad for t in p.values() if isinstance(t, torch.Tensor))):
            raise ValueError("expert-parallel MoE over a model axis > 1 runs forward only; "
                             "call it under torch.no_grad() or torch.inference_mode()")
        mrank = rules.mesh.get_coordinate()[rules.mesh.mesh_dim_names.index("model")]
    xt = x.reshape(b * s, d).to(COMPUTE_DTYPE)
    probs, gate_vals, expert_idx = _route(p, xt, cfg)
    aux = _moe_aux(probs, expert_idx, cfg)
    if msize == 1:
        y = _moe_experts(p, xt, cfg, expert_idx, gate_vals, 0, count)
    else:
        y = _moe_experts(p, xt, cfg, expert_idx, gate_vals, mrank * count, count)
        dist.all_reduce(y, group=rules.mesh.get_group("model"))
    if "shared" in p:
        y = y + mlp_apply(p["shared"], xt).to(COMPUTE_DTYPE)
    return y.reshape(b, s, d).to(x.dtype), aux


def _moe_aux(probs: torch.Tensor, expert_idx: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Load-balancing aux loss (Switch): E * sum_e f_e * p_e."""
    e, k = cfg.n_experts, cfg.top_k
    me = probs.mean(0)
    ce = _one_hot(expert_idx, e).sum(1).float().mean(0) / k
    return e * torch.sum(me * ce)


def moe_apply(p: Params, x: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter-dispatch MoE (Switch/GShard): top-k routing with a capacity;
    tokens past an expert's capacity fall through on the residual path.
    Returns (out in x's dtype, the float32 load-balancing aux loss).  Under
    rules with a ``"model"`` axis that divides the experts, a ``moe_ep``
    config takes the expert-parallel route."""
    rules = current_rules()
    if cfg.moe_ep and rules is not None and "model" in mesh_axes(rules.mesh) \
            and cfg.n_experts % mesh_axes(rules.mesh)["model"] == 0:
        return _moe_apply_ep(p, x, cfg, rules)
    b, s, d = x.shape
    xt = x.reshape(b * s, d).to(COMPUTE_DTYPE)
    probs, gate_vals, expert_idx = _route(p, xt, cfg)
    aux = _moe_aux(probs, expert_idx, cfg)
    y = _moe_experts(p, xt, cfg, expert_idx, gate_vals, 0, cfg.n_experts)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], xt).to(COMPUTE_DTYPE)
    return y.reshape(b, s, d).to(x.dtype), aux


# ------------------------------------------------------------------- RG-LRU
def rglru_init(gen: torch.Generator, cfg: ModelConfig, device=None) -> Params:
    d = cfg.d_model
    w = cfg.lru_width or d
    dev = _init_device(gen, device)
    return {
        "w_in_x": dense_init(gen, d, w, cfg, device=device),  # input branch
        "w_in_g": dense_init(gen, d, w, cfg, device=device),  # gate branch
        "conv": (torch.randn((cfg.conv_width, w), generator=gen, device=dev) * 0.1).to(
            _pdtype(cfg)),
        "wa": dense_init(gen, w, w, cfg, scale=0.5, device=device),  # recurrence gate
        "wx": dense_init(gen, w, w, cfg, scale=0.5, device=device),  # input gate
        "lam": torch.full((w,), 2.0, dtype=_pdtype(cfg), device=dev),  # softplus^-1(a)
        "w_out": dense_init(gen, w, d, cfg, device=device),
    }


@dataclasses.dataclass
class RecState:
    """RG-LRU decode state: h [B, W] float32, conv [B, conv_width - 1, W]
    the conv's tail.  Stacked groups carry a leading group axis."""

    h: torch.Tensor
    conv: torch.Tensor


def _associative_scan(combine, elems: tuple, dim: int) -> tuple:
    """``jax.lax.associative_scan`` over ``dim`` (>= 0), by its recursion:
    combine neighbour pairs, scan the reduced sequence, then combine each
    scanned pair with the next even element.  The same combine tree, so the
    same products and sums in the same order."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems
    at = (slice(None),) * dim

    def sl(start, stop=None, step=1):
        return at + (slice(start, stop, step),)

    odd = _associative_scan(combine, combine(tuple(t[sl(0, n - 1, 2)] for t in elems),
                                             tuple(t[sl(1, None, 2)] for t in elems)), dim)
    head = odd if n % 2 else tuple(t[sl(0, -1)] for t in odd)
    even = combine(head, tuple(t[sl(2, None, 2)] for t in elems))
    out = []
    for t, ev, od in zip(elems, even, odd):
        r = torch.empty_like(t)
        r[sl(0, 1)] = t[sl(0, 1)]
        r[sl(2, None, 2)] = ev
        r[sl(1, None, 2)] = od
        out.append(r)
    return tuple(out)


def _lru_combine(lhs: tuple, rhs: tuple) -> tuple:
    a1, b1 = lhs
    a2, b2 = rhs
    return a1 * a2, b1 * a2 + b2


def _rglru_core(u: torch.Tensor, p: Params, h0: torch.Tensor, c: float = 8.0):
    """u [B, S, W]; returns (y [B, S, W] in u's dtype, h_final [B, W]
    float32), by the associative scan of h_t = a_t h_{t-1} + b_t."""
    uc = u.float()
    r = _sigmoid(uc @ p["wa"].float())
    i = _sigmoid(uc @ p["wx"].float())
    lam = p["lam"].float()
    log_a0 = -torch.logaddexp(-lam, torch.zeros_like(lam))  # log sigmoid(lam); F.softplus cuts at 20
    a = torch.exp(c * r * log_a0[None, None, :])
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-9)) * (i * uc)
    a_sc, b_sc = _associative_scan(_lru_combine, (a, b), dim=1)
    h = b_sc + a_sc * h0[:, None, :].float()
    return h.to(u.dtype), h[:, -1, :]


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (the tanh approximation) op by op in x's dtype
    (``F.gelu(approximate="tanh")`` rounds once)."""
    c = torch.tensor(0.7978845608028654, dtype=x.dtype, device=x.device)  # sqrt(2 / pi)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x * (x * x))))))


def rglru_apply(
    p: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    mode: str,
    state: Optional[RecState] = None,
) -> tuple[torch.Tensor, Optional[RecState]]:
    """The recurrent block: a gelu gate branch, a short causal depthwise
    conv and the RG-LRU on the input branch.  ``"decode"`` (one token)
    writes the new h and conv tail into ``state`` in place and returns it;
    ``"prefill"`` returns a new state, ``"train"`` none."""
    b, s, _ = x.shape
    w = cfg.lru_width or cfg.d_model
    xc = x.to(COMPUTE_DTYPE)
    u = xc @ p["w_in_x"].to(COMPUTE_DTYPE)  # [B, S, W]
    g = _gelu(xc @ p["w_in_g"].to(COMPUTE_DTYPE))
    cw = cfg.conv_width
    conv = p["conv"].to(COMPUTE_DTYPE)
    if mode == "decode":
        assert state is not None
        hist = torch.cat([state.conv.to(COMPUTE_DTYPE), u], dim=1)  # [B, cw, W]
        conv_out = torch.einsum("bcw,cw->bw", hist, conv)[:, None, :]
        y_core, h_fin = _rglru_core(conv_out, p, state.h)
        state.h.copy_(h_fin)
        state.conv.copy_(hist[:, 1:, :])
        new_state = state
    else:
        up = torch.cat([torch.zeros((b, cw - 1, w), dtype=COMPUTE_DTYPE, device=x.device), u],
                       dim=1)
        stacked = torch.stack([up[:, i : i + s, :] for i in range(cw)], dim=2)  # [B, S, cw, W]
        conv_out = torch.einsum("bscw,cw->bsw", stacked, conv)
        h0 = torch.zeros((b, w), dtype=torch.float32, device=x.device) if state is None else state.h
        y_core, h_fin = _rglru_core(conv_out, p, h0)
        new_state = (RecState(h=h_fin, conv=up[:, -(cw - 1):, :].to(COMPUTE_DTYPE))
                     if mode == "prefill" else None)
    y = (y_core * g) @ p["w_out"].to(COMPUTE_DTYPE)
    return y.to(x.dtype), new_state


# -------------------------------------------------------------------- RWKV6
def _wkv_chunked(r, k, v, w, u, s0, chunk: int):
    """Chunked-parallel WKV6.  Within a chunk of C steps the decay
    factorizes per channel, exp(cl_{t-1} - cl_u) = exp(cl_{t-1}) exp(-cl_u),
    so the chunk's own contribution is an attention-like [C, C] product and
    the state advances once a chunk; log-space cumsums with a -60 clamp keep
    exp(-cl_u) finite.

    r, k, v, w: [B, S, H, K] (w the per-step decay in (0, 1]); u: [H, K];
    s0: [B, H, K, V] float32.  Returns (S_final, y [B, S, H*K] bf16)."""
    b, s, h, kd = r.shape
    nc = s // chunk
    clamp = -60.0

    def cshape(t):
        return t.float().reshape(b, nc, chunk, h, kd).transpose(0, 1)  # [nc, B, C, H, K]

    rf, kf, vf = cshape(r), cshape(k), cshape(v)
    lw = torch.log(torch.clamp(cshape(w), 1e-38, 1.0))
    cl = torch.cumsum(lw, dim=2)  # inclusive within-chunk cumulative log-decay
    r_dec = rf * torch.exp(torch.clamp(cl - lw, min=clamp))
    k_dec = kf * torch.exp(torch.clamp(-cl, min=clamp))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.float32, device=r.device),
                     diagonal=-1)[None, None]  # strict t > u
    uu = u[None, None]  # [1, 1, H, K]
    state, ys = s0, []
    for c in range(nc):
        rd, kdec, vv, cl_c, rraw, kraw = r_dec[c], k_dec[c], vf[c], cl[c], rf[c], kf[c]
        y_inter = torch.einsum("bchk,bhkv->bchv", rd, state)
        att = torch.einsum("bchk,bdhk->bhcd", rd, kdec) * tri  # c = t, d = u
        y_intra = torch.einsum("bhcd,bdhv->bchv", att, vv)
        y_diag = torch.sum(rraw * uu * kraw, dim=-1)[..., None] * vv
        ys.append((y_inter + y_intra + y_diag).to(COMPUTE_DTYPE))
        total = cl_c[:, -1]  # [B, H, K]
        k_fold = kraw * torch.exp(torch.clamp(total[:, None] - cl_c, min=clamp))
        state = state * torch.exp(total)[..., None] + torch.einsum("bchk,bchv->bhkv", k_fold, vv)
    return state, torch.stack(ys, dim=1).reshape(b, s, h * kd)


def rwkv_init(gen: torch.Generator, cfg: ModelConfig, device=None) -> Params:
    d, hk = cfg.d_model, cfg.rwkv_head_dim
    h = d // hk
    dev, pd = _init_device(gen, device), _pdtype(cfg)
    lora = max(32, d // 16)

    def mix(n):
        return (torch.rand((n, d), generator=gen, device=dev) * 0.5 + 0.25).to(pd)

    return {
        # token-shift mix coefficients (static lerp + data-dependent lora)
        "mix_rkvwg": mix(5),
        "w_lora_a": dense_init(gen, d, lora, cfg, scale=0.1, device=device),
        "w_lora_b": dense_init(gen, lora, d, cfg, scale=0.1, device=device),
        "decay_base": torch.full((h, hk), -6.0, dtype=pd, device=dev),
        "bonus_u": torch.zeros((h, hk), dtype=pd, device=dev),
        "wr": dense_init(gen, d, d, cfg, device=device),
        "wk": dense_init(gen, d, d, cfg, device=device),
        "wv": dense_init(gen, d, d, cfg, device=device),
        "wg": dense_init(gen, d, d, cfg, device=device),
        "wo": dense_init(gen, d, d, cfg, device=device),
        "ln_x": rmsnorm_init(d, cfg, dev),
        # channel-mix
        "cm_mix": mix(2),
        "cm_k": dense_init(gen, d, cfg.d_ff, cfg, device=device),
        "cm_v": dense_init(gen, cfg.d_ff, d, cfg, device=device),
        "cm_r": dense_init(gen, d, d, cfg, device=device),
    }


@dataclasses.dataclass
class RwkvState:
    """RWKV decode state: wkv [B, H, K, V] float32, shift_t and shift_c
    [B, D] the last token of the time-mix and of the channel-mix."""

    wkv: torch.Tensor
    shift_t: torch.Tensor
    shift_c: torch.Tensor


def rwkv_apply(
    p: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    mode: str,
    state: Optional[RwkvState] = None,
) -> tuple[torch.Tensor, Optional[RwkvState]]:
    """RWKV6 (Finch) block: time-mix with a data-dependent decay, then
    channel-mix.  The WKV runs chunked when ``cfg.rwkv_chunked`` divides S
    and S is at least two chunks, else step by step (decode's one token).
    ``"decode"`` writes the new state into ``state`` in place and returns
    it; ``"prefill"`` returns a new state, ``"train"`` none."""
    b, s, d = x.shape
    hk = cfg.rwkv_head_dim
    h = d // hk
    xc = x.to(COMPUTE_DTYPE)
    zero = torch.zeros((b, 1, d), dtype=COMPUTE_DTYPE, device=x.device)
    prev_t = state.shift_t.to(COMPUTE_DTYPE)[:, None, :] if state is not None else zero
    x_prev = torch.cat([prev_t, xc[:, :-1, :]], dim=1)
    mix = p["mix_rkvwg"].to(COMPUTE_DTYPE)  # [5, D]

    def lerp(i):
        return xc + (x_prev - xc) * mix[i][None, None, :]

    def proj(i, name):
        return (lerp(i) @ p[name].to(COMPUTE_DTYPE)).reshape(b, s, h, hk)

    r, kk, vv = proj(0, "wr"), proj(1, "wk"), proj(2, "wv")
    g = _silu(lerp(4) @ p["wg"].to(COMPUTE_DTYPE))
    # data-dependent decay (v6): w = exp(-exp(base + lora(x)))
    dd = (lerp(3) @ p["w_lora_a"].to(COMPUTE_DTYPE)) @ p["w_lora_b"].to(COMPUTE_DTYPE)
    decay = torch.exp(-torch.exp(torch.clamp(
        p["decay_base"].float().reshape(1, 1, d) + dd.float(), -20.0, 2.0))).reshape(b, s, h, hk)
    u = p["bonus_u"].float()  # [H, K]
    s0 = state.wkv.float() if state is not None else torch.zeros(
        (b, h, hk, hk), dtype=torch.float32, device=x.device)

    chunk = cfg.rwkv_chunked
    if chunk and s >= 2 * chunk and s % chunk == 0:
        s_fin, y = _wkv_chunked(r, kk, vv, decay, u, s0, chunk)
    else:
        s_fin, ys = s0, []
        for t in range(s):
            kv = torch.einsum("bhk,bhv->bhkv", kk[:, t].float(), vv[:, t].float())
            ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t].float(),
                                   s_fin + u[None, :, :, None] * kv).to(COMPUTE_DTYPE))
            s_fin = s_fin * decay[:, t].float()[..., None] + kv
        y = torch.stack(ys, dim=1)
    y = rmsnorm(y.reshape(b, s, d), p["ln_x"], cfg.norm_eps) * g
    att = (y @ p["wo"].to(COMPUTE_DTYPE)).to(x.dtype)

    # channel-mix (with its own shift)
    xa = xc + att.to(COMPUTE_DTYPE)
    prev_c = state.shift_c.to(COMPUTE_DTYPE)[:, None, :] if state is not None else zero
    xa_prev = torch.cat([prev_c, xa[:, :-1, :]], dim=1)
    cmix = p["cm_mix"].to(COMPUTE_DTYPE)
    xk = xa + (xa_prev - xa) * cmix[0][None, None, :]
    xr = xa + (xa_prev - xa) * cmix[1][None, None, :]
    kq = torch.square(torch.relu(xk @ p["cm_k"].to(COMPUTE_DTYPE)))
    cm = _sigmoid(xr @ p["cm_r"].to(COMPUTE_DTYPE)) * (kq @ p["cm_v"].to(COMPUTE_DTYPE))
    out = (att.to(COMPUTE_DTYPE) + cm).to(x.dtype)

    new_state = None
    if mode == "decode":
        assert state is not None
        state.wkv.copy_(s_fin)
        state.shift_t.copy_(xc[:, -1, :])
        state.shift_c.copy_(xa[:, -1, :])
        new_state = state
    elif mode == "prefill":
        new_state = RwkvState(wkv=s_fin, shift_t=xc[:, -1, :], shift_c=xa[:, -1, :])
    return out, new_state
