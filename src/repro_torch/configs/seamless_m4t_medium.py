"""seamless-m4t-medium [audio]: 12L d_model=1024 16H (GQA kv=16) d_ff=4096
vocab=256206 — enc-dec, multimodal [arXiv:2308.11596; hf].

The audio frontend is a STUB per the assignment: input_specs() provides
precomputed frame embeddings [B, S_enc, d_model] for the encoder; the
decoder consumes tokens.  vocab 256206 is padded to 256256 (multiple of
128) for 16-way sharding — DESIGN.md §5.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,        # decoder layers
    n_enc_layers=12,    # encoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    head_dim=64,
    audio_frames_ratio=0.5,
)
