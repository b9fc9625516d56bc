"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (GQA kv=1) d_ff=12288
vocab=256000 — RG-LRU + local attention at 1:2 [arXiv:2402.19427; unverified].

Block pattern (rec, rec, local) repeats from layer 0; 38 = 12 full groups +
a 2-layer (rec, rec) tail, handled as unscanned tail blocks.  Runs the
long_500k cell: local attention window 2048 + O(1) recurrent state.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    block_pattern=("rec", "rec", "local"),
    local_window=2048,
    lru_width=4096,
    conv_width=4,
    param_dtype="bfloat16",
)
