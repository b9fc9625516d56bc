"""rwkv6-1.6b [ssm]: 24L d_model=2048 (attn-free) d_ff=7168 vocab=65536 —
Finch: data-dependent decay [arXiv:2404.05892; unverified].

Attention-free: WKV6 recurrence with token-shift; 32 heads of dim 64.
Runs the long_500k cell (O(1) state).  KV-cache compression is inapplicable
(DESIGN.md §5) — the WKV state is residual-quantized instead.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,          # wkv heads = d_model / rwkv_head_dim
    n_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    rwkv_head_dim=64,
    # production default after the §Perf hillclimb: chunked-parallel WKV
    # (227x lower HBM-traffic bound vs the sequential scan; EXPERIMENTS.md
    # §Perf H1).  Baseline tables were recorded with rwkv_chunked=0.
    rwkv_chunked=256,
)
