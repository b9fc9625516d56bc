"""Shared set-up of the benchmark's CPU tests: the benchmark's folder and
the port on the import path, tiny configurations and mixes, and a job
factory that drives a run on the CPU (the runners' own path, without the
harness's look for a card)."""
from __future__ import annotations

import pathlib
import sys
import time

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_DENSE = {"name": "tiny-dense", "family": "dense", "n_layers": 2, "d_model": 64,
              "n_heads": 4, "n_kv_heads": 2, "head_dim": 16, "d_ff": 128, "vocab_size": 512,
              "rope_theta": 10000.0, "norm_eps": 1e-5, "tie_embeddings": False,
              "param_dtype": "bfloat16"}
TINY_MOE = {"name": "tiny-moe", "family": "moe", "n_layers": 3, "d_model": 64, "n_heads": 4,
            "n_kv_heads": 4, "d_ff": 96, "vocab_size": 512, "rope_theta": 10000.0,
            "norm_eps": 1e-6, "tie_embeddings": False, "mla": True, "kv_lora_rank": 32,
            "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16, "n_experts": 8,
            "n_shared_experts": 2, "top_k": 2, "moe_d_ff": 32, "first_dense_layers": 1,
            "capacity_factor": 1.25, "param_dtype": "bfloat16"}
PREFILL_MIX = {"runner": "prefill",
               "prompt_lengths": {"dist": "lognormal", "median": 24, "sigma": 0.7, "min": 8,
                                  "max": 64, "count": 4},
               "check": {"requests": 3}}
KV_MIX = {"runner": "kv_park",
          "session_lengths": {"dist": "lognormal", "median": 16, "sigma": 0.8, "min": 4,
                              "max": 64, "total_tokens": 100},
          "cache": {"k_spread": 1.0, "v_spread": 0.5}, "codec": {"block": 256, "bits": 8},
          "check": {"sessions": 3}}
# the tiny cells' own limits: bf16 against float32 at d_model 64 reads about
# 1e-2 (a sound run; the last layer's cache 0.009-0.018) where a broken path
# reads 0.3 or more and the fp8 control's cache 0.15-0.39; the codec on the
# CPU equals the reference bit for bit
PREFILL_LIMITS = {"logit_err": 0.1, "token_gap": 0.5, "cache_err": 0.05}
KV_LIMITS = {"dev_max_steps": 0.5, "dev_rms_steps": 0.01}


@pytest.fixture
def make_job():
    import torch

    from harness import common, main

    def make(cell: str, mc: dict, mix: dict, limits: dict, seed: int = 2**31 + 17,
             seconds: float = 0.5, trace: bool = False):
        bench = common.load_benchmark()
        return main.Job(bench=bench, cell=common.find_cell(bench, cell),
                        config={"model_config": mc}, mix=mix, limits=limits, seed=seed,
                        seconds=seconds, trace=trace, device=torch.device("cpu"),
                        t0=time.perf_counter())

    return make
