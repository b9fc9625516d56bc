"""llama-3.2-vision-11b [vlm]: 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 — cross-attn image layers every 5th layer
[hf:meta-llama/Llama-3.2-11B-Vision; unverified].

The vision frontend is a STUB per the assignment: input_specs() provides
precomputed patch embeddings [B, vision_tokens, d_model]; every 5th decoder
layer cross-attends to them.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    head_dim=128,
    rope_theta=500_000.0,
    cross_attn_every=5,
    vision_tokens=1600,
    param_dtype="bfloat16",
)
