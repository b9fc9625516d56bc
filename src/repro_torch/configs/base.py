"""Model and shape configuration, counterpart of ``repro.configs.base``
(a copy: the configs are plain dataclasses, so the port holds the same
fields and values; ``tests/test_torch_models.py`` compares them).

Every architecture is a ``ModelConfig`` in its own module
(``repro_torch/configs/<id>.py``).  ``SHAPES`` defines the four input-shape
cells; ``cells_for(arch)`` drops the ones an arch does not run.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["ModelConfig", "ShapeSpec", "SHAPES", "cells_for", "reduced_config"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None  # default d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    vocab_pad_multiple: int = 128

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0  # per-expert hidden dim
    first_dense_layers: int = 0  # leading layers with a dense FFN
    moe_every: int = 1  # MoE FFN on every k-th layer (llama4 interleaves 1:1)
    capacity_factor: float = 1.25

    # --- MLA (deepseek) ---
    mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- hybrid (recurrentgemma): repeating block pattern ---
    # e.g. ("rec", "rec", "local") = RG-LRU : local-attn at 2:1
    block_pattern: tuple = ("attn",)
    local_window: int = 2048
    lru_width: int = 0  # RG-LRU state width (default d_model)
    conv_width: int = 4

    # --- rwkv ---
    rwkv_head_dim: int = 64

    # --- enc-dec ---
    n_enc_layers: int = 0

    # --- vlm ---
    cross_attn_every: int = 0  # one cross-attn layer per this many layers
    vision_tokens: int = 0  # stub frontend: precomputed patch embeddings

    # --- audio (enc-dec stub frontend) ---
    audio_frames_ratio: float = 0.5  # fraction of the shape's seq for encoder

    # --- precision / memory ---
    param_dtype: str = "float32"  # "bfloat16" for the very large archs
    remat: bool = True
    scan_blocks: bool = True

    # --- perf levers (hillclimb opt-ins; baselines keep defaults) ---
    rwkv_chunked: int = 0  # >0: chunked-parallel WKV with this chunk length
    masked_cache_update: bool = False  # decode: one-hot masked write, no DUS
    attn_softmax_bf16: bool = False  # keep attention probs in bf16 end-to-end
    remat_policy: str = "nothing"  # "nothing" (full recompute) | "dots"
    force_head_sharding: bool = False  # shard heads over "model" even if non-divisible (GSPMD pads)
    moe_ep: bool = False  # expert-parallel replicated-dispatch MoE (shard_map)

    # --- distribution ---
    dcn_fsdp: bool = False  # shard params across the pod axis too (ZeRO-3)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // max(self.n_heads, 1)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing (SSM state or local attention)."""
        return self.family in ("ssm", "hybrid")

    @property
    def block_group(self) -> tuple:
        """The smallest repeating layer pattern (the scan unit)."""
        if self.family == "hybrid":
            return self.block_pattern
        if self.family == "vlm" and self.cross_attn_every:
            return ("attn",) * (self.cross_attn_every - 1) + ("cross",)
        if self.family == "ssm":
            return ("rwkv",)
        if self.n_experts and self.moe_every > 1:
            return ("attn",) * self.moe_every
        return ("attn",)

    def layer_uses_moe(self, i: int) -> bool:
        if not self.n_experts or i < self.first_dense_layers:
            return False
        return (i % self.moe_every) == (self.moe_every - 1)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for rooflines."""
        d, ff, v = self.d_model, self.d_ff, self.padded_vocab
        hd = self.resolved_head_dim
        n_q = self.n_heads * hd
        n_kv = self.n_kv_heads * hd
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.mla:
            attn = d * (self.n_heads * (self.qk_nope_head_dim + self.qk_rope_head_dim))
            attn += d * (self.kv_lora_rank + self.qk_rope_head_dim)
            attn += self.kv_lora_rank * self.n_heads * (self.qk_nope_head_dim + self.v_head_dim)
            attn += self.n_heads * self.v_head_dim * d
        else:
            attn = d * n_q + 2 * d * n_kv + n_q * d
        dense_mlp = 3 * d * ff
        per_layer = []
        for i in range(self.n_layers):
            kind = self.block_group[i % len(self.block_group)]
            if kind == "rec":
                w = self.lru_width or d
                mix = 2 * d * w + w * d + w * self.conv_width + 2 * w * (w // 16)
            elif kind == "rwkv":
                mix = 4 * d * d + d * (d // 16) * 2  # r,k,v,o + lora mixers
            else:
                mix = attn
            if self.layer_uses_moe(i):
                mlp = 3 * d * self.moe_d_ff * (self.n_experts + self.n_shared_experts)
                mlp += d * self.n_experts
            else:
                mlp = dense_mlp
            per_layer.append(mix + mlp)
        total = emb + sum(per_layer)
        if self.n_enc_layers:
            total += self.n_enc_layers * (attn + dense_mlp)
        if self.family == "vlm":
            total += 0  # frontend is a stub; cross-attn counted via blocks
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        full = self.param_count()
        moe_layers = sum(1 for i in range(self.n_layers) if self.layer_uses_moe(i))
        all_experts = 3 * d * self.moe_d_ff * self.n_experts * moe_layers
        active = 3 * d * self.moe_d_ff * self.top_k * moe_layers
        return int(full - all_experts + active)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def cells_for(cfg: ModelConfig) -> list[str]:
    """The assigned shape cells this arch actually runs (skips documented in
    DESIGN.md §5: long_500k needs sub-quadratic attention)."""
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.supports_long_context:
        cells.append("long_500k")
    return cells


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    pattern = cfg.block_group
    n_layers = max(len(pattern), 2 if len(pattern) == 1 else len(pattern))
    if cfg.family == "vlm":
        n_layers = len(pattern)  # one full group (incl. the cross layer)
    changes = dict(
        n_layers=n_layers,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) or 1,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        vocab_pad_multiple=64,
        param_dtype="float32",
        local_window=32,
        scan_blocks=cfg.scan_blocks,
    )
    if cfg.n_experts:
        # capacity_factor 8 -> dropless at smoke-test sizes, so incremental
        # decode is bitwise-consistent with the full forward (Switch-style
        # capacity drops are prefill/decode skew by construction).
        changes.update(n_experts=4, top_k=min(cfg.top_k, 2), moe_d_ff=64,
                       n_shared_experts=min(cfg.n_shared_experts, 1),
                       first_dense_layers=min(cfg.first_dense_layers, 1),
                       capacity_factor=8.0)
    if cfg.mla:
        changes.update(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                       v_head_dim=16)
    if cfg.family == "hybrid":
        changes.update(lru_width=64, n_layers=len(cfg.block_pattern))
    if cfg.n_enc_layers:
        changes.update(n_enc_layers=2)
    if cfg.family == "ssm":
        changes.update(rwkv_head_dim=16, n_layers=2)
    if cfg.vision_tokens:
        changes.update(vision_tokens=16)
    return dataclasses.replace(cfg, **changes)
