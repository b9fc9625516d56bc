"""flash_fwd_roofline.prefill: the least time the card could take for the
prefills' causal attention over the device time of the port's flash
forward kernels (``csrc/flash_attention.cu``) in the trace.

A layer over a prompt of S tokens: S (S + 1) / 2 query-key pairs a head,
2 (D_qk + D_v) flops each; q, k, v read and the output written once in
bf16 (MLA: its keys and values expanded per head, V at its unpadded 128).
The bound is the larger of flops at the bf16 peak and bytes at the
memory's rate.  The requests counted are every request whose kernels are
in the trace."""
from harness.peaks import BF16_FLOPS, HBM_BYTES_PER_S
from harness.readers import kernel_seconds, share

PATTERNS = (r"flash_tc_kernel", r"flash_kernel")


def layer_work(mc: dict, s: int) -> tuple[int, int]:
    """(flops, bytes) of one layer's attention over s tokens."""
    h = mc["n_heads"]
    if mc.get("mla"):
        dqk, dv, kvh = mc["qk_nope_head_dim"] + mc["qk_rope_head_dim"], mc["v_head_dim"], h
    else:
        dqk = dv = mc.get("head_dim") or mc["d_model"] // h
        kvh = mc["n_kv_heads"]
    flops = h * (dqk + dv) * s * (s + 1)
    nbytes = 2 * s * (h * dqk + kvh * dqk + kvh * dv + h * dv)
    return flops, nbytes


def bound_seconds(mc: dict, s: int) -> float:
    flops, nbytes = layer_work(mc, s)
    return mc["n_layers"] * max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def read(view):
    if view is None or view.trace is None:
        return None
    took = kernel_seconds(view.trace, PATTERNS)
    return share(sum(bound_seconds(view.mc, s) for s in view.dispatched), took)
