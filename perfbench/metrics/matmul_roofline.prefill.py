"""matmul_roofline.prefill: the least time the card could take for the
prefills' matrix products (projections, MLP, router, experts, the head on
the last position) over the device time of the GEMM kernels in the trace.

Each product [m, k] x [k, n] counts 2 m k n flops and its operands and
result once (bf16; the router's in float32, as the port runs it); its
bound is the larger of flops at the bf16 peak and bytes at the memory's
rate.  An expert product counts the rows the top-k routing sends (S x k)
and every expert's weights read.  The requests counted are every request
whose kernels are in the trace."""
from harness.peaks import BF16_FLOPS, HBM_BYTES_PER_S
from harness.readers import kernel_seconds, share

PATTERNS = (r"gemm", r"gemv", r"nvjet", r"xmma", r"cutlass", r"splitKreduce", r"cublas")
EXCLUDE = (r"flash",)


def products(mc: dict, s: int) -> list:
    """(m, k, n, batch of weights read, bytes an element) of each product of
    one prompt of s tokens."""
    d, h = mc["d_model"], mc["n_heads"]
    if mc.get("mla"):
        nd, rd, vd, lora = (mc["qk_nope_head_dim"], mc["qk_rope_head_dim"], mc["v_head_dim"],
                            mc["kv_lora_rank"])
        attn = [(s, d, h * (nd + rd)), (s, d, lora), (s, d, rd), (s, lora, h * nd),
                (s, lora, h * vd), (s, h * vd, d)]
    else:
        hd = mc.get("head_dim") or d // h
        kv = mc["n_kv_heads"] * hd
        attn = [(s, d, h * hd), (s, d, kv), (s, d, kv), (s, h * hd, d)]
    attn = [(m, k, n, 1, 2) for m, k, n in attn]

    def mlp(ff):
        return [(s, d, ff, 1, 2), (s, d, ff, 1, 2), (s, ff, d, 1, 2)]

    n_layers = mc["n_layers"]
    n_moe = n_layers - mc.get("first_dense_layers", 0) if mc.get("n_experts") else 0
    out = (attn + mlp(mc["d_ff"])) * (n_layers - n_moe)
    if n_moe:
        e, ff, rows = mc["n_experts"], mc["moe_d_ff"], s * mc["top_k"]
        moe = [(s, d, e, 1, 4), (rows, d, ff, e, 2), (rows, d, ff, e, 2), (rows, ff, d, e, 2)]
        if mc.get("n_shared_experts"):
            moe += mlp(ff * mc["n_shared_experts"])
        out += (attn + moe) * n_moe
    return out + [(1, d, mc["vocab_size"], 1, 2)]


def bound_seconds(mc: dict, s: int) -> float:
    t = 0.0
    for m, k, n, batch, size in products(mc, s):
        flops = 2 * m * k * n
        nbytes = size * (m * k + batch * k * n + m * n)
        t += max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
    return t


def read(view):
    if view is None or view.trace is None:
        return None
    took = kernel_seconds(view.trace, PATTERNS, EXCLUDE)
    return share(sum(bound_seconds(view.mc, s) for s in view.dispatched), took)
