"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=102400 — MLA kv_lora=512, 2 shared + 64 routed top-6
[arXiv:2405.04434; hf].

d_ff=1408 is the per-expert hidden dim; the first layer uses a dense FFN
(10944) per the HF config.  MLA: qk_nope=128, qk_rope=64, v_head=128.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,          # dense first layer
    vocab_size=102400,
    mla=True,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    first_dense_layers=1,
    param_dtype="bfloat16",
    # §Perf: expert-parallel replicated-dispatch MoE (EXPERIMENTS.md
    # §Perf-extended #6) — production default; baseline tables used False.
    moe_ep=True,
)
