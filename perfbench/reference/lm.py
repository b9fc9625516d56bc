"""The plain reference of the prefill cells: a decoder's last-position
logits and its last layer's cache at every position, in float32 (TF32
off), plain PyTorch, one layer at a time over all the prompts it is
given, so that it fits beside nothing else on the card.

It follows the published blocks: RMSNorm, RoPE on the pairs (d, d + D/2),
causal softmax attention with grouped KV heads (Mistral-NeMo), or MLA with
its keys and values expanded per head (DeepSeek-V2), the SwiGLU MLP, and
the MoE (a softmax router, the top k experts of each token by a stable
sort, each expert's SwiGLU over the rows routed to it, the shared experts
on every row).  Where the configuration's ``departures`` say the port
differs from the published model (DeepSeek-V2-Lite: no YaRN, the top-k
gates normalised, the port's expert capacity with drops in token order)
this follows the port, so that a difference found is a fault, not a
choice.

It imports nothing of the program: it reads the configuration's
``model_config`` and the weights and prompts that the benchmark made.

``precision="fp8"`` is the control: every product's inputs (the
projections, the experts, q k^T and p v) rounded to float8 e4m3 with a
scale per row (per output column for a weight) first, everything else in
float32, as a program that served the model in fp8 would compute it.
"""
from __future__ import annotations

import contextlib

import torch

_FP8_MAX = 448.0


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off, restored afterwards."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to e4m3 with one scale per slice along ``dim``, back in float32."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / _FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Arith:
    """The products of one precision."""

    def __init__(self, precision: str):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.fp8 = precision == "fp8"

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x [..., K] @ w [K, N], w cast to float32 here."""
        w = w.float()
        if self.fp8:
            x, w = _fp8(x, -1), _fp8(w, 0)
        return x @ w

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of q k^T or p v, rounded along its last axis."""
        return _fp8(x, -1) if self.fp8 else x


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [S, ..., D] at positions 0..S-1: rotates the pairs (d, d + D/2)."""
    s, d = x.shape[0], x.shape[-1]
    half = d // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float64, device=x.device) / half))
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv
    shape = (s,) + (1,) * (x.ndim - 2) + (half,)
    cos, sin = torch.cos(ang).float().reshape(shape), torch.sin(ang).float().reshape(shape)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, ar: Arith, chunk: int = 1024) -> torch.Tensor:
    """softmax(q k^T / sqrt(Dqk)) v over keys at or before each query;
    q [S, H, Dqk], k [S, H, Dqk], v [S, H, Dv] -> [S, H, Dv]."""
    s = q.shape[0]
    scale = q.shape[-1] ** -0.5
    q, k, v = ar.rows(q), ar.rows(k), ar.rows(v)
    out = torch.empty(q.shape[:2] + v.shape[-1:], dtype=torch.float32, device=q.device)
    for a in range(0, s, chunk):
        b = min(a + chunk, s)
        sc = torch.einsum("qhd,khd->hqk", q[a:b], k[:b]) * scale
        qpos = torch.arange(a, b, device=q.device)[:, None]
        sc.masked_fill_(torch.arange(b, device=q.device)[None, :] > qpos, float("-inf"))
        p = ar.rows(torch.softmax(sc, dim=-1))
        out[a:b] = torch.einsum("hqk,khd->qhd", p, v[:b])
    return out


def latent(p: dict, h: torch.Tensor, mc: dict, ar: Arith) -> tuple:
    """MLA's cached latent c [S, kv_lora] (normalised) and its rope key
    [S, rope], one for all heads."""
    c = rmsnorm(ar.mm(h, p["w_dkv"]), p["kv_norm"], mc["norm_eps"])
    return c, rope(ar.mm(h, p["w_krope"]), mc["rope_theta"])


def keys_values(p: dict, h: torch.Tensor, mc: dict, ar: Arith) -> tuple:
    """Grouped attention's K (after RoPE) and V, [S, kv heads, head dim]."""
    s, hd = h.shape[0], mc.get("head_dim") or mc["d_model"] // mc["n_heads"]
    k = rope(ar.mm(h, p["wk"]).reshape(s, mc["n_kv_heads"], hd), mc["rope_theta"])
    return k, ar.mm(h, p["wv"]).reshape(s, mc["n_kv_heads"], hd)


def cache_rows(p: dict, h: torch.Tensor, mc: dict, ar: Arith) -> torch.Tensor:
    """What a prefill caches of one attention layer, a row [C] a position:
    MLA's latent and rope key, or K and V, flattened."""
    a, b = (latent if mc.get("mla") else keys_values)(p, h, mc, ar)
    return torch.cat([a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)], dim=1)


def attention(p: dict, h: torch.Tensor, mc: dict, ar: Arith) -> torch.Tensor:
    s, nh = h.shape[0], mc["n_heads"]
    if mc.get("mla"):
        nd, rd, vd = mc["qk_nope_head_dim"], mc["qk_rope_head_dim"], mc["v_head_dim"]
        q = ar.mm(h, p["wq"]).reshape(s, nh, nd + rd)
        c, k_rope = latent(p, h, mc, ar)
        k_nope = ar.mm(c, p["w_kup"]).reshape(s, nh, nd)
        v = ar.mm(c, p["w_vup"]).reshape(s, nh, vd)
        q = torch.cat([q[..., :nd], rope(q[..., nd:], mc["rope_theta"])], dim=-1)
        k = torch.cat([k_nope, k_rope[:, None, :].expand(s, nh, rd)], dim=-1)
        o = causal_attention(q, k, v, ar)
        return ar.mm(o.reshape(s, nh * vd), p["wo"])
    hd = mc.get("head_dim") or mc["d_model"] // nh
    q = rope(ar.mm(h, p["wq"]).reshape(s, nh, hd), mc["rope_theta"])
    k, v = keys_values(p, h, mc, ar)
    rep = nh // mc["n_kv_heads"]  # query head j reads kv head j // rep
    o = causal_attention(q, k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1), ar)
    return ar.mm(o.reshape(s, nh * hd), p["wo"])


def swiglu(p: dict, x: torch.Tensor, ar: Arith) -> torch.Tensor:
    return ar.mm(torch.nn.functional.silu(ar.mm(x, p["wg"])) * ar.mm(x, p["wu"]), p["wd"])


def moe(p: dict, h: torch.Tensor, mc: dict, ar: Arith, route=None) -> torch.Tensor:
    """Top-k of a softmax router, gates normalised over the k; each expert
    takes the first ``capacity`` (token, slot) pairs routed to it in token
    order (the port's rule, see the module's docstring), then the shared
    experts on every row.  ``route`` [T, k], where given, are the experts
    in place of the router's own top k (a diagnostic: the gates are still
    this router's probabilities of those experts)."""
    t, e, k = h.shape[0], mc["n_experts"], mc["top_k"]
    probs = torch.softmax(ar.mm(h, p["router"]), dim=-1)
    if route is None:
        gates, idx = (x[:, :k] for x in torch.sort(probs, dim=-1, descending=True, stable=True))
    else:
        idx = route.to(device=h.device, dtype=torch.long)
        gates = probs.gather(1, idx)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    cap = max(8, int(mc.get("capacity_factor", 1.25) * t * k / e))
    flat = idx.reshape(-1)  # (token, slot) pairs in token order
    y = torch.zeros_like(h)
    for j in range(e):
        pairs = torch.nonzero(flat == j).reshape(-1)[:cap]
        if pairs.numel() == 0:
            continue
        rows = pairs // k
        w = {n: p[n][j] for n in ("wg", "wu", "wd")}
        y.index_add_(0, rows, swiglu(w, h[rows], ar) * gates.reshape(-1)[pairs][:, None])
    if "shared" in p:
        y = y + swiglu(p["shared"], h, ar)
    return y


def block(p: dict, x: torch.Tensor, mc: dict, ar: Arith, route=None) -> torch.Tensor:
    x = x + attention(p["attn"], rmsnorm(x, p["ln1"], mc["norm_eps"]), mc, ar)
    h = rmsnorm(x, p["ln2"], mc["norm_eps"])
    return x + (moe(p["moe"], h, mc, ar, route) if "moe" in p else swiglu(p["mlp"], h, ar))


def prefill(mc: dict, embed: torch.Tensor, blocks: list, ln_f: torch.Tensor,
            head: torch.Tensor, prompts: list, precision: str = "float32",
            routes: list | None = None) -> tuple[list, list]:
    """Of each prompt ([1, S] ids): the float32 logits [V] at its last
    position, and the last layer's cache rows [S, C] (:func:`cache_rows`),
    the layers taken one at a time over all prompts.  ``routes``, where
    given, holds for each prompt the experts [S, k] of each MoE layer in
    order (see :func:`moe`)."""
    ar = Arith(precision)
    eps = mc["norm_eps"]
    with no_tf32(), torch.no_grad():
        xs = [embed[t.reshape(-1).long()].float() for t in prompts]
        moe_layer = 0
        for i, p in enumerate(blocks):
            if i == len(blocks) - 1:
                caches = [cache_rows(p["attn"], rmsnorm(x, p["ln1"], eps), mc, ar) for x in xs]
            pinned = [r[moe_layer] for r in routes] if routes and "moe" in p else [None] * len(xs)
            xs = [block(p, x, mc, ar, r) for x, r in zip(xs, pinned)]
            moe_layer += "moe" in p
        logits = [ar.mm(rmsnorm(x[-1:], ln_f, eps), head)[0] for x in xs]
    return logits, caches

