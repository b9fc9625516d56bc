"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128 experts top-1 — early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E family; unverified].

Llama-4 Maverick interleaves dense-FFN and MoE layers 1:1 (moe_every=2) with
one shared expert per MoE layer; with the assignment's d_ff=8192 this gives
~395B total / ~14B active — the 400B-A17B class.  40 q-heads are not
divisible by the 16-way model axis; expert-parallelism (128/16=8) carries
the model sharding and attention heads pad 40->48 under GSPMD (DESIGN.md §5,
revisited in the §Perf hillclimb).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    head_dim=128,
    n_experts=128,
    n_shared_experts=1,
    top_k=1,
    moe_d_ff=8192,
    moe_every=2,
    rope_theta=500_000.0,
    param_dtype="bfloat16",
    dcn_fsdp=True,  # ZeRO-3 across pods: 400B state cannot replicate per pod
    # §Perf: GSPMD-padded 40->48 head sharding beats replicated attention
    # 4-9x on the memory term (EXPERIMENTS.md §Perf-extended); production
    # default after validation.  Baseline tables used False.
    force_head_sharding=True,
    # §Perf: expert-parallel replicated-dispatch MoE (EXPERIMENTS.md
    # §Perf-extended #6) — production default; baseline tables used False.
    moe_ep=True,
)
