"""mfu.prefill: the model flops of the prompt tokens prefilled in the
window over the window's host seconds, as a share of the card's bf16 peak.

Model flops of a prompt of S tokens: 2 S x the matmul parameters a token
passes (attention projections, the MLP, or the router, the top-k experts
and the shared experts), the causal attention (S (S + 1) / 2 query-key
pairs a head, 2 (D_qk + D_v) flops each; MLA at its unpadded V), and the
head on the last position only.  The embedding lookup is no matmul."""
from harness.peaks import BF16_FLOPS


def token_matmul_params(mc: dict, moe: bool) -> int:
    """Matmul parameters one token passes in one layer."""
    d, h = mc["d_model"], mc["n_heads"]
    if mc.get("mla"):
        nd, rd, vd, lora = (mc["qk_nope_head_dim"], mc["qk_rope_head_dim"], mc["v_head_dim"],
                            mc["kv_lora_rank"])
        attn = d * h * (nd + rd) + d * lora + d * rd + lora * h * nd + lora * h * vd + h * vd * d
    else:
        hd = mc.get("head_dim") or d // h
        attn = 2 * d * h * hd + 2 * d * mc["n_kv_heads"] * hd
    if moe:
        ff = mc["moe_d_ff"]
        mlp = d * mc["n_experts"] + 3 * d * ff * (mc["top_k"] + mc.get("n_shared_experts", 0))
    else:
        mlp = 3 * d * mc["d_ff"]
    return attn + mlp


def attention_flops(mc: dict, s: int) -> int:
    """Causal attention of one layer over a prompt of s tokens."""
    h = mc["n_heads"]
    if mc.get("mla"):
        dqk, dv = mc["qk_nope_head_dim"] + mc["qk_rope_head_dim"], mc["v_head_dim"]
    else:
        dqk = dv = mc.get("head_dim") or mc["d_model"] // h
    return h * (dqk + dv) * s * (s + 1)


def model_flops(mc: dict, s: int) -> int:
    n = mc["n_layers"]
    n_moe = n - mc.get("first_dense_layers", 0) if mc.get("n_experts") else 0
    per_token = (n - n_moe) * token_matmul_params(mc, False)
    if n_moe:
        per_token += n_moe * token_matmul_params(mc, True)
    return 2 * s * per_token + n * attention_flops(mc, s) + 2 * mc["d_model"] * mc["vocab_size"]


def read(view):
    if view is None or not view.counted or view.window_s <= 0:
        return None
    flops = sum(model_flops(view.mc, s) for s in view.counted)
    return 100.0 * flops / (view.window_s * BF16_FLOPS)
