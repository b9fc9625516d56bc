#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--series 1024] [--samples 16384] [--seed 0]
                          [--ragged-series 1024] [--kv-batch 4]
                          [--gw-series 256] [--gw-samples 131072]
                          [--gw-range-queries 1024] [--gw-analytics-queries 768]
                          [--lm-batch 4] [--lm-len 2048] [--lm-decode 16]
                          [--trace DIR]

Phase 10 takes ``--kv-batch``, ``--gw-series`` and ``--gw-samples``.

Phases, each of which must pass (any failure exits non-zero before the
result line):

1. card: name and power limit from nvidia-smi; build every CUDA kernel
   from ``src/repro_torch/kernels/csrc`` (one nvcc per source, in parallel).
2. main path, the IoT gateway batch: ``ShrinkCodec.compress_batch`` on S
   seeded random walks of T samples (tiers 1e-1, 1e-2, 1e-3 and lossless,
   4 decimals, eps_b = 5% of the range, rANS), then ``decompress_at`` of
   every series at 0.0 (bit-identical to the input) and a progressive
   decode of every tier (|v_hat - v| <= eps).  Kernel launch counts are
   zeroed just before and read just after; each kernel must have run.  The
   timed decode's own ``rans_decode`` launches are counted apart from the
   tier checks': at most one a series (a prefix's layers share a launch).
3. kernels: each kernel against its plain torch version on the card, on
   the inputs the main path gave it, exactly (torch.equal); the cone scan
   also once in float32 and once on an input of the path's shape that
   breaks at every step (eps = -1; ``breaky_ms``), its float64 time also
   as a CUDA graph of 20 calls.  Times from CUDA events; ``rans_decode`` at the
   path's first call (one series' rows) and at that call's first row (the
   shape PR 18 launched), each also as a CUDA graph of 20 calls
   (``graph_ms``, device time without the host's launch overhead).
4. device route vs CPU route: 8 series through ``device="cpu"`` give the
   same SHRK bytes, and so do 8 non-negative ones with zeros of both signs
   (a zero extreme takes numpy's sign in some rows of the batch).
5. golden files: ``tests/golden/golden_v4*.shrk`` decode losslessly on the
   card and re-encode byte for byte.
6. ragged gateway: ``compress_batch`` on S seeded random walks with lengths
   log-uniform over 7..30,000 plus 4 empty and 4 length-1 series, with the
   default ``best`` entropy backend; lossless decode bit-identical, every
   tier within its eps; the cone scan's masked mode against its plain
   version (torch.equal) on the first and the last bucket's inputs, and
   the path's masked scans timed together (``masked_total_ms``) beside the
   largest bucket's byte bound; 8
   series through ``device="cpu"`` give the same bytes; the backend count
   per stream and whether ``zstandard`` imports; the timed decode's
   ``rans_decode`` launches.
7. KV store at llama3-8b width (32 layers, 8 KV heads, head_dim 128, bf16;
   ``src/repro/configs/llama3_8b.py``): prefill caches of 2048 positions
   for a batch of 4, ``promote_caches`` to 8192, ``quantize_cache``,
   ``dequantize_cache``.  ``residual_quant``, ``dequant`` and ``base_fit``
   (the fit, in the reference's summation order) against their plain
   versions on the path's own inputs (torch.equal), ``base_fit`` also
   timed as a CUDA graph of 20 calls; the float32
   reconstruction within half a step of its input plus float32 rounding
   (the largest error in half-steps is printed); memory bits against
   bf16; rows whose bf16 theta/slope differ from the CPU route on a
   sample of 64-row blocks (printed, not hidden).
8. streamed gateway, range serving and analytics at a gateway's scale:
   ``ShrinkStreamCodec`` ingests S = 256 seeded sensors of T = 131,072
   samples (``repro_torch.launch.serve.sensor_values``) chunk-interleaved
   (chunk 4096, frames of 8192, pinned value range, rANS, tiers 1e-2 and
   1e-3 of the range and lossless, 4 decimals, eps_b 2% of the range) into
   a SHRKS container; 1024 range queries through ``RangeQueryBatcher``
   (32 cached frames), each within its eps of the raw values; 768
   ``AnalyticsEngine`` queries in the reference's mix (sketch and tiered
   aggregates, exact ``count_where``), each containing the numpy truth
   and every count exact.  The CPU route gives the same container bytes
   for 8 of the series and the same answers for 64 of the queries; both
   routes' runs of those 64 are timed (q/s side by side), and a third run
   on the card counts its synchronizing CUDA calls.  Every analytics query
   is wrapped: its ``segment_query`` launches (the fused segment step; at
   most one a step, two for a stddev, or the phase fails) and, in the
   third run, its synchronizing calls are printed by query kind (sketch
   aggregate, tiered aggregate, ``count_where``) beside the count before
   the fused step.  ``segment_query`` against its plain version (the
   output buffers read back part by part, bit for bit) on the run's
   largest step and on one query over every frame of the container in
   each mode; its kernel time (profiler), a wrapper call's time (events
   and a CUDA graph), the whole host step (descriptors up, launch, one
   copy back, one sync) for every frame and for one.  ``segment_agg``,
   the row kernel, once through ``ops.segment_agg`` over every segment of
   the container (its launch counted, as the kernel surface calls it),
   then against its plain version in float64 and float32 on those rows,
   timed likewise.
9. dense model at full width and depth: llama3-8b
   (``src/repro/configs/llama3_8b.py``: 32 layers, d_model 4096, 32 heads,
   8 KV heads, head_dim 128, d_ff 14336, vocab 128256; 8,030,261,248 bf16
   params from a seeded generator on the card) prefills 4 x 2048 seeded
   tokens through ``Model.prefill``: one ``flash_attention`` launch a
   layer (32).  The kernel against its plain version on layer 0's q, k, v
   (bf16 at 3e-2, float32 at 2e-5, a length of 2000 that is not a multiple
   of the tile), timed beside its plain version, the bound, and PyTorch's
   ``scaled_dot_product_attention`` (timed only, never on the path): its
   row adds the fraction of the bound and the ratio to SDPA, and a line
   before the kernels line prints its time beside its previous one
   (``PERF.md``, section 6).  The
   prefill caches grafted into decode buffers, 16 greedy decode steps,
   each step's logits held to one forward pass over the extended prompt
   at the reference's bound (atol 0.35, rtol 0.05, top-1 >= 0.99 off
   near ties).  The CPU route: the embeddings, the head and the first 2
   layers prefill 1 x 256 tokens on the CPU and on the card (logits at
   atol 0.1, rtol 0.05).  Then ``repro_torch.launch.serve.main`` with
   ``--mode model --arch llama3-8b`` at its defaults (16 requests, 8 slots,
   8 new tokens, max_seq 128) must serve every request.
10. the kernel surface ``repro_torch.kernels.ops`` (the reference reaches
   these three kernels only through ``repro.kernels.ops``) on the port's
   own data: llama3-8b's K of phase 7 before promotion, cut into the
   tensor codec's blocks of 256 ([1,048,576, 256] float32, its line from
   ``ops.base_fit``), through ``pyramid_quant`` once (steps s, s/16,
   s/256 with s = max |x - pred| / 127, so no layer clips) and
   ``pyramid_reconstruct`` at each layer prefix k: within steps[k] / 2
   of x plus float32 rounding, the error never growing, the full stack
   leaving err; and ``interval_stats`` over windows of 1024 of phase 8's
   series ([131,072, 256]) in float64, float32 and bfloat16.  Each
   output equals its plain version bit for bit (over row passes for the
   ladder); times beside the bounds and, for ``interval_stats``,
   ``torch.aminmax`` over the same windows (timed only, never on the
   path) and each dtype's own byte bound, with its previous times
   (``PERF.md``, section 6) printed beside the new ones; both
   ``interval_stats`` and ``aminmax`` are also timed as one CUDA graph of
   20 calls (``graph_ms``), which keeps the host's launch overhead out.
11. the serving tier, through the port's entry points: ragged gateway
   ingest of ``ragged_sensor_traffic(256, 1000, seed=0)`` (rates
   log-uniform over 2..512 samples a tick; its generation timed apart)
   through one ``RaggedBatcher`` on the card (eps_b 0.4, eps 8e-3, rANS,
   4 buckets, flushes of 2**21 samples): every series read back in 4
   range queries within eps, and the first 50 ticks of 32 sensors give
   the same container on the CPU route; a ``KBStore`` of those 32
   series, one ref-mode archive each, written on the card and on the CPU
   route (the same archives and SHKS snapshot bytes), then ``serve --mode
   kbstore`` at its defaults on the card; ``serve --mode chaos`` at its
   defaults on the card and the CPU route (no silent corruption; the
   container and the tallies of phases 1 and 3 equal, phase 2 runs on the
   real clock); ``run_fleet_sim`` with 4 shards, 256 series, 480 ticks,
   768 queries, frames of 2048 on the card (no silent corruption, no byte
   mismatch against the 1-shard oracle, the shard-kill tail typed or
   flagged; p50/p99 latencies and the reference's critical-path model,
   the shards sharing the one card).  ``cone_scan``, ``rans_encode``,
   ``rans_decode`` and ``segment_query`` must each launch inside the
   phase; their rows carry ``launches_serving_tier``.
12. models slice B at full width, one family at a time (the params freed
   between them), from ``src/repro/configs/<arch>.py`` with params from a
   seeded generator on the card: deepseek-v2-lite-16b at full depth (27
   layers, d_model 2048, MLA with lora 512, nope 128, rope 64, v 128; 64
   routed experts top-6 and 2 shared; a dense first layer; ~15.7 B bf16
   params); llama4-maverick-400b-a17b cut to one group of 2 layers (a
   dense and an MoE layer of 128 experts of 5120 x 8192, top-1, one
   shared; the cut: 48 layers would not fit); recurrentgemma-9b (38
   layers, 12 x (rec, rec, local) + a (rec, rec) tail), rwkv6-1.6b (24),
   llama-3.2-vision-11b (40, a cross layer every 5th; vision stub
   [4, 1600, 4096]) and seamless-m4t-medium (12 + 12; frames
   [4, 1024, 1024] and 4 x 1024 tokens, the reference's split) at full
   depth.  Each prefills 4 x 2048 seeded tokens (an MoE at its capacity
   factor 1.25) with one ``flash_attention`` launch a causal
   self-attention layer (27, 2, 0, 0, 40, 12; checked), then prefills
   1008 tokens (llama4 240: its dropless experts buffer E x tokens x d),
   grafts the caches into decode buffers (a cross cache whole, a local
   ring at slot = pos % buffer), decodes 16 greedy steps and holds each
   step's logits to one forward pass over the extended prompt (1024
   tokens, a length ``_sdpa``'s query chunks take) at the reference's
   bound (atol 0.35, rtol 0.05, top-1 >= 0.99 off near ties).  An MoE
   decodes at a dropless capacity (capacity_factor = n_experts / top_k,
   so cap == tokens): capacity drops make prefill and decode differ by
   construction (``src/repro/configs/base.py:218-220``).  Its router's
   near ties do too: a random-init router is nearly uniform, so the
   decode's and the forward's rounding pick another k-th expert for some
   tokens; the forward routes the decoded tokens to the decode's experts
   (``PinnedRouting``), each such flip must be a near tie, and the
   comparison with the forward's own routing is printed, not held.
   deepseek also holds the kernel at its shape (q, k [4, 2048, 16, 192],
   V padded from 128) to its plain version on layer 0's inputs (bf16 at
   3e-2), times it beside SDPA on the unpadded V (timed only) and the
   bound on the unpadded work, and runs its embeddings, head, prefix
   layer and first MoE layer over 1 x 256 tokens on the CPU (plain
   versions) and the card (logits at atol 0.1, rtol 0.05).  Then
   ``serve --mode model --arch deepseek-v2-lite-16b`` at the launcher's
   defaults and each other family ``--reduced``: every request served.
   The flash row carries each path's launches and the MLA check.
13. training at qwen3-0.6b's full width (``src/repro/configs/qwen3_0_6b.py``:
   28 layers, d_model 1024, 16 heads over 8 KV heads of 128, d_ff 3072,
   vocab 151,936, qk_norm, tied embeddings, float32 params):
   (a) the flash backward pair (``csrc/flash_attention_bwd.cu``), given
   the forward's lse, against autograd through ``flash_attention_plain``
   at q [2, 2048, 16, 128] over 8 KV heads and at MLA's [1, 1024, 16, 192]
   with V padded from 128, bf16, causal (each gradient within 3e-2 of its
   largest |value|), and at a small float32 shape on the scalar route
   (1e-4); two launches the same bits; each case's route printed (the
   bf16 shapes must take the tensor cores, float32 the scalar pair);
   then timed at the training shape [2, 4096, 16/8, 128] (events and a
   CUDA graph) beside the scalar pair's, its bound (5 products over the
   causal pairs, 3.44e11 flop at 989 TFLOP/s) and the pair's 7-product
   floor (both as fractions), its plain version and SDPA's backward
   (forward and backward less the forward; timed, never on the path).
   (b) qwen3-0.6b cut to its first 2 layers at full width, batch 1 x
   2048: every gradient finite, one ``flash_attention_bwd`` launch a
   layer, and each leaf within 6% of its largest |gradient| of the plain
   attention route on the card and of the CPU route (the worst printed
   beside the scalar pair's).  (c) ``launch.train
   --arch qwen3-0.6b --steps 12 --batch 2 --seq 4096 --ckpt-every 100``
   at full depth into a temporary directory (removed after): the launch
   counts zeroed just before and read just after, every loss finite, the
   last 4 below the first 4; the median step, tokens/s (both beside the
   scalar pair's), each step's time, peak memory and the flash launches a
   step.
   The cut: train_4k's batch 256 to 2 (one
   card).  (d) at (b)'s cut, batch 2 x 512: 10 steps through the
   ``TrainingRunner`` (checkpoints every 3) against a crash at step 7 and
   a resume: the params equal leaf by leaf (``torch.equal``).  (e) two
   ``make_compressed_train_step`` steps on a one-rank NCCL DeviceMesh with
   a "pod" dimension: ``base_fit`` launched and equal to its plain version
   on the step's first blocks, the elements where the exchange differs
   from the CPU route's printed, the wire bytes; then the same two steps
   on a one-rank ("pod", "data", "model") mesh from params placed by
   ``param_shardings`` (the step on each rank's ``param_specs`` shards, the
   exchange on whole blocks of each leaf): every state leaf, the error
   feedback and the losses bit-equal to the whole-params run.  (f) a
   ``shrink:1e-3`` checkpoint of (d)'s leaves of at most 65,536 elements (the per-series
   codec takes minutes on a leaf of 10^8) on the card and the CPU route:
   every SHRK leaf file equal, read back within eps; a ``MetricsLogger``
   flush of (c)'s and (d)'s losses, read back losslessly; ``cone_scan``,
   ``rans_encode`` and ``rans_decode`` launched.  The kernels line gains
   the ``flash_attention_bwd`` row (launches: (c)'s run).
14. the parallel layer on a DeviceMesh, on one-rank NCCL meshes on the card
   (the multi-rank part on gloo processes on the CPU): (a) qwen3-0.6b at
   full width and depth, 3 data-parallel steps (``make_train_step`` over a
   ("data", "model") = (1, 1) mesh) at [2, 4096] against the one-device
   step from the same params, each run after a discarded warm-up step:
   every state leaf bit-equal, each run's median step; (e) (a)'s state saved and restored through
   ``param_shardings`` onto a new ("pod", "data", "model") mesh, every
   leaf equal, and training resumed from it: one data-parallel step on
   that mesh from the restored DTensors bit-equal to the one-device step
   from (a)'s state; (d) ``make_crosspod_exchange`` at qwen3-0.6b's leaves
   (seeded gradients) on a (1, 1, 1) mesh, plain and compressed, a leaf
   at a time and flat: one pod's plain mean equal to its gradient, the
   compressed one within 5% of each leaf's largest |gradient|
   (``base_fit`` launched), the wire bytes against float32; (f) one train
   step with ``remat_policy="dots"`` and one with ``"nothing"`` at (a)'s
   batch: every leaf equal, the peak memory of each; (b)
   deepseek-v2-lite-16b at full width and depth, prefill of 4 x 2048 with
   ``moe_ep`` under the (1, 1) mesh's rules (26 expert-parallel MoE
   layers, 27 flash launches) against the dense path: within (0.02,
   0.02), the bits and the max |diff| printed; (c) one MoE layer at
   deepseek's full expert width on 4 gloo processes (16 experts a rank,
   2048 tokens) against the dense ``moe_apply`` within (0.02, 0.02).  The
   ``flash_attention``, ``flash_attention_bwd`` and ``base_fit`` rows
   gain ``launches_by_path["parallel (phase 14)"]`` ((a) and (b), (a),
   (d)).
15. the dry run and the paper's baselines: (b) qwen3-0.6b's train step at
   [2, 4096] (phase 13's cut) and llama3-8b's prefill at [4, 2048] (phase
   9's), each counted by ``launch.cost_analysis.analyze_step`` on the card
   and on meta tensors: flops, bytes, matmul count and kernels equal (the
   differing ops printed otherwise); the median of 5 steps (CUDA events)
   beside the count's eager-traffic bound max(flops / 989e12, bytes /
   3.35e12) (the bytes every eager op moves, unfused, which is more than
   the step's function needs), the step's share of that bound and its
   model-flops share model_flops_total / (step_s x 989e12); (c)
   ``gateway_batch(4, 65536)`` through every registry entry of
   ``repro_torch.baselines`` on the card: lossy at 1e-2 and 1e-3 of each
   row's range within the reference test's bound, lossless bit-exact (GD at
   the gateway's decimals), every blob equal to the CPU route's, the first
   row's decodes equal to the CPU route's; each method's ratio and seconds
   beside SHRINK's ratio on the same rows; TRC's ``rans_encode`` and
   ``rans_decode`` launches; (a) then ``python -m repro_torch.launch.dryrun
   --all``, ``--all --multi-pod`` and the ``--compressed`` qwen3-0.6b cell,
   each a subprocess on the host's CPU (no card), all three at once and
   after every phase timed on the card, phase 16's (c) running on a thread
   beside them (each reports its own wall; they share the host's cores):
   every cell written, no ``FAILED__`` file, each cell's dominant term and
   fit.  The flash rows gain
   ``launches_by_path["dry-run check (phase 15)"]``, the rANS rows
   ``"baselines (phase 15)"``.
16. sharded state and tensor parallelism: (a) qwen3-0.6b at full width and
   depth, 3 steps of ``make_train_step`` on a one-rank NCCL ("data",
   "model") mesh from params placed by ``param_shardings`` (DTensors; the
   step holds each rank's ``param_specs`` shards, gathers a block at a
   time and splits heads, ffn and vocab over "model", here groups of one)
   at [2, 4096]: loss, grad norm and every state leaf bit-equal to phase
   14 (a)'s one-device run from the same seed, the flash launches a step;
   then, each from its own state on one batch after a warm-up step, 3
   rounds of (one device, sharded, control, control, sharded, one device),
   the control being the sharded step with torch.distributed's
   collectives replaced by their one-rank result (a copy): the medians
   and their ratios, every chain's losses equal; one sharded step traced
   (collective calls, their host time, the NCCL kernels' device time, the
   collectives' autograd Functions); (b) phase 9's llama3-8b prefill (4 x
   2048, the same seed and tokens) through the sharded
   ``make_prefill_step`` on that mesh (the global batch; its logits and
   caches come back as DTensors): logits bit-equal to phase 9's; (e) its
   caches grafted into decode buffers of phase 9's length, then phase 9's
   16 decode steps (its tokens fed) through the sharded
   ``make_decode_step`` (the reference's decode layout: heads, ffn and
   vocab over "model", the caches placed by ``cache_specs``): each step's
   logits bit-equal to phase 9's, the median step beside phase 9's, one
   more step traced (collective calls and their host ms); (f) each of
   phase 12's families (llama4 cut as there) on the same mesh, every
   family split over "model" as its rules say: phase 12's prefill (same
   seed, params and inputs) through the sharded ``make_prefill_step``,
   logits bit-equal to phase 12's; phase 12's decode check (its prompt,
   capacity and tokens fed) through the sharded prefill and 16 steps of
   ``make_decode_step``, each step's logits bit-equal to phase 12's; one
   sharded train step of the first group of layers at full width (2 x
   2048; llama4 at 2 experts) bit-equal to the one-device step, deepseek's
   and llama4's through the expert-parallel MoE (their ``moe_ep``; its
   calls counted); each
   run's seconds beside phase 12's; then the flash pair against its plain
   versions at a rank's shapes under 16-way TP (deepseek's 1 MLA head at
   d 192, V padded from 128; the VLM's 2 heads of 128; seamless's 1 head
   of 64; llama4's forced tiles: 3 heads on 1 kv head, 3 on 3, 1 on 1),
   each timed beside its bound, the plain forward and SDPA's; (c) on the
   host's CPU during phase 15's sweeps, one launch of 4 gloo processes for
   all its cases:
   ``tests/torch_tp_case.py``'s reduced dense config (4 heads, 1 kv head
   replicated over "model" and 2 split) and its family cases (deepseek's
   MLA and shared expert, its expert-parallel MoE (``mla_ep``),
   recurrentgemma, rwkv6, the VLM, seamless on 2 x 2; llama4's 6 heads
   forced over a model axis of 4 on 1 x 4, ranks holding 2, 2, 2 and 0
   heads) on 4 gloo processes, 3 sharded steps
   and a prefill of the global batch against the one-device step within
   the bounds that ``tests/test_torch_tensor_parallel.py`` holds, then
   for the dense config a prefill and 6 sharded decode steps (the caches'
   sequence split over "model", one step with a rank holding no written
   slot, two either side of the pieces' boundary) against one device
   within the logit and cache bounds that
   ``tests/test_torch_decode_parallel.py`` holds, then the compressed
   step on a sharded state on a (pod 2, data 2) mesh against the
   whole-params step (its exchange bit-equal to ``compressed_psum_tree``
   on whole leaves; ``tests/test_torch_crosspod.py``'s bounds); (d) the
   dense configs' and the five families' ``train_4k``, ``prefill_32k`` and
   ``decode_32k`` cells of phase 15 (a)'s 16x16 sweep: per-rank argument
   and temporary bytes, fit and collective bytes (the families' beside
   the tree's before their TP), and deepseek's and llama4's ``train_4k``
   on both meshes through EP beside the tree's before it (each must
   fit), and llama4's ``train_4k`` and ``prefill_32k`` on both meshes
   with its 40 heads split over 16 ranks in GSPMD's tiles, rank 0's flops
   beside the tree's before (at least 3x fewer; each must fit).  The
   flash rows gain ``launches_by_path["sharded (phase 16)"]`` ((a)'s 3
   steps and (b)) and ``["sharded families (phase 16)"]`` ((f)'s prefills
   and train steps).  The card's name and power
   limit open the phase's summary line.

Each path's launch counts are zeroed just before it and read just after;
each kernel the path runs must have run.
With ``--trace DIR`` phase 8 also profiles an eighth of its ingest and
128 of its analytics queries (torch.profiler: device busy share and top
device ops; cProfile: the host functions with the most time), phases 9
and 12 (deepseek) a prefill and four decode steps (torch.profiler), phase
13 one train step of qwen3-0.6b at full depth (torch.profiler), and a last
phase times the main path stage by stage
(the codec's own functions, called in its order) and traces one
compress_batch and the lossless decode of 64 series with torch.profiler:
device time by kernel and copy, the device busy share (the union of the
trace's device events over the profiled window), and a Chrome trace in
DIR; the decode of those 64 series also under cProfile (the host
functions with the most cumulative time).

The last two lines are the kernels line and the result line:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import argparse
import atexit
import concurrent.futures
import contextlib
import dataclasses
import io
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s; FP64 and FP32
# outside the tensor cores; INT32 as 132 SMs x 64 INT32 lanes x 1.98 GHz boost (one
# operation per lane-cycle).
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12
F32_OPS_PER_S = 67e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
TIERS = [1e-1, 1e-2, 1e-3, 0.0]
DECIMALS = 4
GOLDEN_N, GOLDEN_DECIMALS = 1536, 3  # tests/golden/regen.py
# llama3-8b's decode KV cache (src/repro/configs/llama3_8b.py): layers,
# KV heads, head_dim; prefill and decode buffer lengths
KV_LAYERS, KV_HEADS, KV_DIM = 32, 8, 128
KV_PREFILL, KV_MAX_SEQ = 2048, 8192
KV_CHUNK_ROWS = 1 << 20  # rows per pass of the plain versions' comparisons
# phase 8: the serve launcher's frame, chunk and cache sizes; the series and
# queries the CPU route repeats
GW_FRAME, GW_CHUNK, GW_CACHE = 8192, 4096, 32
GW_CPU_SERIES, GW_CPU_QUERIES = 8, 64
GW_QUERY_SEED = 1  # the reference launcher's query seed
# phase 9: llama3-8b at full width and depth (src/repro/configs/llama3_8b.py)
LM_ARCH = "llama3-8b"
LM_CPU_LAYERS, LM_CPU_LEN = 2, 256  # the CPU route's layers and prompt
CPU_ROUTE_TOL = (0.1, 0.05)  # tests/test_torch_models.py's logit bound
FLASH_BF16_TOL, FLASH_F32_TOL = 3e-2, 2e-5  # tests/test_kernels.py's bounds
BF16_OPS_PER_S = 989e12  # dense bf16 tensor-core peak
# the flash kernel's previous time at the path's shape (PERF.md section 6,
# row 10: the scalar kernel before the tensor-core one, run C)
FLASH_PREV_MS = {"scalar kernel, run C": 13.22}
SERVE_REQUESTS = 16  # the serve launcher's default
# phase 10: interval_stats' window over the gateway's series; rows per pass
# of the ladder's plain comparisons; the ladder's qmax and its three steps
# as fractions of the coarsest
SURF_WINDOW = 1024
SURF_CHUNK_ROWS = 1 << 17
SURF_QMAX = 127
SURF_STEP_FRACTIONS = (1.0, 1 / 16, 1 / 256)
# rans_decode's previous time at the path's first call, 1 row x 256 steps x
# 64 lanes (PERF.md section 6, row 3: the block-a-row kernel, PR 18 runs A-D,
# events over 20 calls)
RANS_DECODE_PREV_MS = {"block a row, PR 18 runs A-D": [0.08738, 0.09069]}
# interval_stats' previous times at [131072, 256], W 1024 (PERF.md section
# 6, row 4: the one-element-a-thread kernel, runs A and B)
# synchronizing CUDA calls an analytics query (64 queries) before the fused
# segment step, with a segment_agg launch a frame (PERF.md, sections 5 and 6)
SYNCS_PER_QUERY_PREV = {"a segment_agg launch a frame": 57.1}
INTERVAL_PREV_MS = {
    "float64": {"one element a thread, run A": 0.09576, "run B": 0.09532},
    "float32": {"one element a thread, run A": 0.05397, "run B": 0.05360},
    "bfloat16": {"one element a thread, run A": 0.07621, "run B": 0.08508},
}
# phase 11: the serving tier (ragged ingest, KB store, chaos, fleet)
SERVE_SENSORS, SERVE_TICKS = 256, 1000  # ragged_sensor_traffic's size
SERVE_CONFIG = {"eps_b": 0.4, "lam": 1e-4}  # the ingest and fleet launchers' codec
SERVE_EPS = 8e-3  # the ingest and fleet launchers' eps (8 x 1e-3)
SERVE_FLUSH = 1 << 21  # samples a ragged flush at the gateway's scale
SERVE_BUCKETS = 4
SERVE_CUT = (50, 32)  # ticks, sensors of the CPU route's byte check
SERVE_RANGES = 4  # range reads a series in the decode check
FLEET_SHARDS, FLEET_SERIES, FLEET_QUERIES, FLEET_FLUSH = 4, 256, 768, 2048
FLEET_TICKS = 480
SERVING_KERNELS = ("cone_scan", "rans_encode", "rans_decode", "segment_query")
# phase 12: models slice B at full width (src/repro/configs/<arch>.py), one
# family at a time; llama4's depth is cut to one group (a dense and an MoE
# layer: one MoE layer's experts alone are 32 GB of bf16)
FAMILIES = ("deepseek-v2-lite-16b", "llama4-maverick-400b-a17b", "recurrentgemma-9b",
            "rwkv6-1.6b", "llama-3.2-vision-11b", "seamless-m4t-medium")
FAMILY_LAYERS = {"llama4-maverick-400b-a17b": 2}
FAMILY_BATCH, FAMILY_LEN, FAMILY_DECODE = 4, 2048, 16
# the decode check's prompt: prompt + 16 steps = 1024 tokens, a length
# every attention route takes (``_sdpa`` chunks queries by 1024); llama4's
# is shorter because its dropless experts buffer E x tokens x d_model
FAMILY_DECODE_PROMPT = {"llama4-maverick-400b-a17b": 240}
FAMILY_DECODE_PROMPT_DEFAULT = 1008
MOE_CPU_LAYERS, MOE_CPU_LEN = 2, 256  # the prefix layer and the first MoE layer


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def sync_time(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def event_ms(fn, reps: int) -> float:
    """Mean time of one call on the card, from CUDA events around ``reps``
    calls after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device time of one call, from CUDA events around one replay of
    a CUDA graph that holds ``reps`` calls: the host's launch overhead,
    which can exceed a short kernel's own time, stays out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def max_abs_err(got, want) -> float:
    """Largest |kernel - plain| over all outputs (equal entries count 0)."""
    worst = 0.0
    for a, b in zip(got, want):
        if a.shape != b.shape:
            return float("inf")
        d = (a.double() - b.double()).abs()
        d[a == b] = 0.0
        if d.numel():
            worst = max(worst, float(d.nan_to_num(nan=float("inf")).max()))
    return worst


class Recorder:
    """Stands in for a module attribute and keeps the arguments of the
    first call, so the kernels can be checked and timed on exactly the
    inputs the main path gave them."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.args = None
        setattr(module, name, self)

    def __call__(self, *args, **kwargs):
        if self.args is None:
            self.args = (args, kwargs)
        return self.orig(*args, **kwargs)

    def restore(self) -> None:
        setattr(self.module, self.name, self.orig)


def gateway_batch(series: int, samples: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.round(np.cumsum(rng.standard_normal((series, samples)), axis=1) * 0.1, 4)


def tier_bound(eps: float, v: torch.Tensor) -> float:
    """The repo's per-tier bound: eps plus a few ulps of the data scale
    (tests/test_pyramid_property.py)."""
    return eps * (1 + 1e-9) + 4 * float(np.finfo(np.float64).eps) * max(1.0, float(v.abs().max()))


def main_path(P, values: np.ndarray, dev: torch.device, launches: dict) -> dict:
    codec = P.ShrinkCodec.from_fraction(values, frac=0.05, backend="rans", device=dev)
    v = torch.as_tensor(values, device=dev)
    torch.cuda.reset_peak_memory_stats()
    css, t_compress = sync_time(lambda: codec.compress_batch(v, TIERS, decimals=DECIMALS))
    blobs = [P.cs_to_bytes(cs) for cs in css]
    parsed = [P.cs_from_bytes(b) for b in blobs]
    before = launches["rans_decode"]
    outs, t_decode = sync_time(lambda: [codec.decompress_at(cs, 0.0) for cs in parsed])
    decode_launches = launches["rans_decode"] - before
    for i, out in enumerate(outs):
        check(torch.equal(out, v[i]), f"series {i}: lossless decode differs from the input")
    del outs
    # one decode launch a series and lane count (every series here has 64 lanes)
    check(0 < decode_launches <= len(parsed),
          f"the timed decode made {decode_launches} rans_decode launches for {len(parsed)} series")
    worst = [0.0] * len(TIERS)
    for i, cs in enumerate(parsed):
        dec = P.ProgressiveDecoder(cs, dev)
        for k, eps in enumerate(TIERS):
            err = float((dec.prefix(k) - v[i]).abs().max())
            check(err <= tier_bound(eps, v[i]), f"series {i} tier {eps}: error {err}")
            worst[k] = max(worst[k], err)
    archive = sum(len(b) for b in blobs)
    return {
        "codec": codec,
        "blobs": blobs,
        "series": values.shape[0],
        "samples": values.shape[1],
        "archive_bytes": archive,
        "compression_ratio": P.BYTES_PER_ROW * values.size / archive,
        "compress_s": t_compress,
        "decompress_at_lossless_s": t_decode,
        "decode_rans_launches": decode_launches,
        "tier_check_rans_launches": launches["rans_decode"] - before - decode_launches,
        "max_tier_error": dict(zip(map(str, TIERS), worst)),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "segments": sum(cs.base.segment_count() for cs in css),
    }


def scan_bound_ms(shape, itemsize: int = 8) -> float:
    """The cone scan's byte bound: x and eps read, brk (int32), theta,
    psi_lo and psi_hi written (44 bytes a point in float64), fin_lo and
    fin_hi; its ~9 operations a point (4 adds, 2 divisions, 3 compares)
    take less time at the FP64 peak."""
    t_len, s = shape
    nbytes = t_len * s * (5 * itemsize + 4) + 2 * s * itemsize
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, 9 * t_len * s / FP64_OPS_PER_S)


def check_scan_equal(cs_mod, what: str, x, eps, lengths=None) -> tuple[float, float]:
    """The kernel against its plain version on one input, every output
    exactly; returns (max |kernel - plain|, ms of the plain version)."""
    got = cs_mod.cone_scan_cuda(x, eps, lengths)
    want, plain_s = sync_time(lambda: cs_mod.cone_scan_plain(x, eps, lengths))
    err = max_abs_err(got, want)
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          f"{what} cone_scan kernel differs from its plain version (max err {err})")
    return err, plain_s * 1e3


def check_cone_scan(cs_mod, x, eps, launches: int) -> dict:
    """The float64 kernel (the main path's) and the float32 one, each against
    its plain version; the row describes the float64 kernel and carries the
    float32 check beside it, the float64 time as a CUDA graph of 20 calls
    (``graph_ms``) and an input of the same shape that breaks at every step
    (eps = -1 crosses every pair of candidate slopes): each break costs the
    window scan one more pass (``breaky_ms``)."""
    t_len, s = x.shape
    res = {}
    for dtype in (torch.float64, torch.float32):
        xd, ed = x.to(dtype), eps.to(dtype)
        err, plain_ms = check_scan_equal(cs_mod, str(dtype), xd, ed)
        ms = event_ms(lambda: cs_mod.cone_scan_cuda(xd, ed), 5)
        res[dtype] = (err, ms, plain_ms)
    breaky = torch.full_like(eps, -1.0)
    breaky_err, _ = check_scan_equal(cs_mod, "every-step-break", x, breaky)
    err, ms, plain_ms = res[torch.float64]
    return {
        "name": "cone_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/cone_scan.cu",
        "replaces": "src/repro/kernels/cone_scan.py:41",
        "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": scan_bound_ms(x.shape), "bound_by": "bytes",
        "library_ms": None, "shape": [t_len, s], "dtype": "float64",
        "graph_ms": graph_ms(lambda: cs_mod.cone_scan_cuda(x, eps), 20),
        "f32_max_abs_err": res[torch.float32][0], "f32_ms": res[torch.float32][1],
        "f32_plain_ms": res[torch.float32][2], "f32_bound_ms": scan_bound_ms(x.shape, 4),
        "breaky_ms": event_ms(lambda: cs_mod.cone_scan_cuda(x, breaky), 3),
        "breaky_max_abs_err": breaky_err,
    }


def check_rans(rk, enc_args, dec_args, launches: dict) -> list[dict]:
    sym, freqs, k = enc_args
    r, n = sym.shape
    steps = -(-n // k)
    cells = torch.full((r, steps * k), rk.ID_SYM, dtype=torch.int16, device=sym.device)
    cells[:, :n] = sym
    freqs = freqs.long()
    got = rk.encode_cells_cuda(cells, freqs, k)
    want, plain_s = sync_time(lambda: rk.encode_cells_plain(cells, freqs, k))
    err = max_abs_err(got, want)
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          f"rans_encode kernel differs from its plain version (max err {err})")
    ms = event_ms(lambda: rk.encode_cells_cuda(cells, freqs, k), 10)
    n_cells = r * steps * k
    enc_bytes = n_cells * (2 + 1 + 2) + r * 256 * 8 + r * k * 8
    enc_ops = 10 * n_cells
    rows = [{
        "name": "rans_encode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rans.cu",
        "replaces": "src/repro/kernels/rans.py:77",
        "launches": launches["rans_encode"], "max_abs_err": err, "ms": ms,
        "plain_ms": plain_s * 1e3,
        "bound_ms": 1e3 * max(enc_bytes / HBM_BYTES_PER_S, enc_ops / INT32_OPS_PER_S),
        "bound_by": "bytes" if enc_bytes / HBM_BYTES_PER_S >= enc_ops / INT32_OPS_PER_S
        else "operations",
        "library_ms": None, "rows": r, "steps": steps, "lanes": k, "cells": n_cells,
    }]
    states, freqs_d, words, word_off, word_cnt, ns, kd = dec_args[0]
    shapes = {
        "batched": (states, freqs_d, words, word_off, word_cnt, ns),
        # PR 18 launched one layer's rows a call: this is its first call's row
        "one_row": (states[:1], freqs_d[:1], words, word_off[:1], word_cnt[:1], ns[:1]),
    }
    dec = {}
    for name, args in shapes.items():
        rd = args[0].shape[0]
        cols = int((-(-args[5] // kd)).max()) * kd
        got = rk.decode_rows_cuda(*args, kd, cols)
        want, plain_s = sync_time(lambda: rk.decode_rows_plain(*args, kd, cols))
        err = max_abs_err(got, want)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"rans_decode kernel differs from its plain version at the {name} shape "
              f"(max err {err})")
        def call():
            return rk.decode_rows_cuda(*args, kd, cols)
        d_cells = rd * cols
        # the rows' own words, their states and tables and counts read once;
        # symbols and word counts written once; ~10 integer operations a cell
        dec_bytes = (int(args[4].sum()) * 2 + rd * (kd * 8 + 256 * 8 + 3 * 8) + d_cells
                     + rd * 8)
        dec_ops = 10 * d_cells
        dev_ms = graph_ms(call, 20)
        dec[name] = {
            "err": err, "ms": event_ms(call, 20), "graph_ms": dev_ms,
            "plain_ms": plain_s * 1e3,
            "bound_ms": 1e3 * max(dec_bytes / HBM_BYTES_PER_S, dec_ops / INT32_OPS_PER_S),
            "bound_by": "bytes" if dec_bytes / HBM_BYTES_PER_S >= dec_ops / INT32_OPS_PER_S
            else "operations",
            "rows": rd, "steps": cols // kd, "lanes": kd, "cells": d_cells,
            "words": int(args[4].sum()), "per_step_ns": dev_ms * 1e6 / (cols // kd),
        }
    one, batch = dec["one_row"], dec["batched"]
    print(f"rans_decode at 1 row x {one['steps']} steps x {kd} lanes: {one['graph_ms']:.5f} ms "
          f"device (graph), {one['ms']:.5f} ms a call (events); PR 18: "
          f"{RANS_DECODE_PREV_MS}; {batch['rows']} rows (the path's call): "
          f"{batch['graph_ms']:.5f} ms device, {batch['ms']:.5f} ms a call", flush=True)
    rows.append({
        "name": "rans_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rans.cu",
        "replaces": "src/repro/kernels/rans.py:148",
        "launches": launches["rans_decode"], "max_abs_err": max(one["err"], batch["err"]),
        "ms": batch["ms"], "plain_ms": batch["plain_ms"], "bound_ms": batch["bound_ms"],
        "bound_by": batch["bound_by"], "library_ms": None,
        **{k: batch[k] for k in ("graph_ms", "rows", "steps", "lanes", "cells", "words",
                                 "per_step_ns")},
        "one_row": {k: v for k, v in one.items() if k != "err"},
    })
    return rows


def ragged_walks(series: int, seed: int) -> list[np.ndarray]:
    """The README's ragged gateway traffic: random walks of log-uniform
    lengths over 7..30,000, plus 4 empty and 4 length-1 series."""
    rng = np.random.default_rng(seed + 1)
    lengths = np.exp(rng.uniform(np.log(7), np.log(30_000), series)).astype(np.int64)
    lengths = np.concatenate([lengths, [0] * 4, [1] * 4])
    return [np.round(np.cumsum(rng.standard_normal(n)) * 0.1, 4) for n in lengths]


def ragged_path(P, E, ops, cs_mod, arrs: list[np.ndarray], dev) -> dict:
    """Phase 6: the ragged gateway batch through the default backend."""
    allv = np.concatenate(arrs)
    codec = P.ShrinkCodec.from_fraction(allv, frac=0.05, device=dev)
    check(codec.backend == "best", f"default backend is {codec.backend!r}, not 'best'")
    scans = []
    orig = ops.cone_scan

    def recording_scan(*args):
        scans.append(args)
        return orig(*args)

    ops.cone_scan = recording_scan
    try:
        ops.reset_launches()
        css, t_compress = sync_time(lambda: codec.compress_batch(arrs, TIERS, decimals=DECIMALS))
        blobs = [P.cs_to_bytes(cs) for cs in css]
        parsed = [P.cs_from_bytes(b) for b in blobs]
        before = ops.launches["rans_decode"]
        outs, t_decode = sync_time(lambda: [codec.decompress_at(cs, 0.0) for cs in parsed])
        decode_launches = ops.launches["rans_decode"] - before
        for i, cs in enumerate(parsed):
            v = torch.as_tensor(arrs[i], device=dev)
            check(torch.equal(outs[i], v), f"ragged series {i}: lossless decode differs")
            if not v.numel():
                continue
            dec = P.ProgressiveDecoder(cs, dev)
            for k, eps in enumerate(TIERS):
                err = float((dec.prefix(k) - v).abs().max())
                check(err <= tier_bound(eps, v), f"ragged series {i} tier {eps}: error {err}")
        launches = dict(ops.launches)
    finally:
        ops.cone_scan = orig
    check(launches["cone_scan"] == len(scans) > 0, "the ragged path ran no masked cone scan")
    backends: dict[str, int] = {}
    for cs in parsed:
        for layer in cs.pyramid.layers:
            if layer.payload:
                name = E.backend_name(layer.payload[0])
                backends[name] = backends.get(name, 0) + 1
    if backends.get("rans"):
        for name in ("rans_encode", "rans_decode"):
            check(launches[name] > 0, f"rANS streams but kernel {name} was not launched")
    # the masked scan against its plain version on the path's own inputs
    masked = {}
    for which, (x, eps, ln) in (("first", scans[0]), ("last", scans[-1])):
        check(ln is not None, "the ragged path's scan ran without lengths")
        err, plain_ms = check_scan_equal(cs_mod, f"masked ({which} bucket)", x, eps, ln)
        masked[which] = {"shape": list(x.shape), "max_abs_err": err,
                         "ms": event_ms(lambda: cs_mod.cone_scan_cuda(x, eps, ln), 5),
                         "plain_ms": plain_ms, "bound_ms": scan_bound_ms(x.shape)}

    def all_buckets():
        for args in scans:
            cs_mod.cone_scan_cuda(*args)

    # the path's masked scans together, beside the largest bucket's bound
    largest = max(scans, key=lambda a: a[0].numel())[0].shape
    masked_total = {
        "masked_total_ms": event_ms(all_buckets, 5),
        "masked_total_bound_ms": sum(scan_bound_ms(a[0].shape) for a in scans),
        "masked_largest_shape": list(largest), "masked_largest_bound_ms": scan_bound_ms(largest),
    }
    # 8 series through the CPU route: the same bytes
    ns = np.array([a.size for a in arrs])
    order = np.argsort(ns, kind="stable")
    pick = sorted({int(i) for i in (order[0], order[4], order[8], order[9],
                                    order[len(order) // 2], order[-2], order[-1], 17)})[:8]
    cpu = P.ShrinkCodec(codec.config, device="cpu")
    cpu_blobs = [P.cs_to_bytes(cs) for cs in cpu.compress_batch([arrs[i] for i in pick], TIERS,
                                                                decimals=DECIMALS)]
    check(cpu_blobs == [blobs[i] for i in pick], "ragged: CPU route bytes differ from the card's")
    archive = sum(len(b) for b in blobs)
    return {
        "series": len(arrs), "samples": int(ns.sum()), "min_len": int(ns.min()),
        "max_len": int(ns.max()), "archive_bytes": archive,
        "compression_ratio": P.BYTES_PER_ROW * int(ns.sum()) / archive,
        "compress_s": t_compress, "decompress_at_lossless_s": t_decode,
        "decode_rans_launches": decode_launches,
        "launches": launches, "buckets": len(scans), "backend_streams": backends,
        "zstandard_importable": "zstd" in E.available_backends(),
        "cpu_route_series": pick, "masked_scan": masked, "masked_total": masked_total,
    }


def kv_caches(P_layers, batch: int, seed: int, dev):
    """Seeded prefill caches of llama3-8b's width in the stacked ``groups``
    form: K and V [32, B, 2048, 8, 128] bf16, normal values with a
    log-normal scale per (KV head, channel), some channels large as in
    real K caches; kpos [32, B, 2048]."""
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (KV_LAYERS, batch, KV_PREFILL, KV_HEADS, KV_DIM)
    out = []
    for spread in (1.0, 0.5):  # K's channels spread wider than V's
        scale = torch.exp(torch.randn((KV_HEADS, KV_DIM), device=dev, generator=g) * spread)
        out.append((torch.randn(shape, device=dev, generator=g) * scale).to(torch.bfloat16))
    kpos = torch.arange(KV_PREFILL, dtype=torch.int32, device=dev).expand(
        KV_LAYERS, batch, KV_PREFILL).contiguous()
    return {"prefix": [], "groups": {"pos0": {"self": P_layers.AttnCache(out[0], out[1], kpos)}},
            "tail": []}


def chunked_equal(kernel_out, plain_fn, rows: int,
                  chunk: int = KV_CHUNK_ROWS) -> tuple[bool, float, float]:
    """Compare kernel outputs [M, ...] with the plain version, run over row
    chunks (the same work as one call, in bounded memory); returns (equal,
    max |kernel - plain|, seconds of the plain passes)."""
    ok, worst, plain_s = True, 0.0, 0.0
    for a in range(0, rows, chunk):
        want, dt = sync_time(lambda: plain_fn(a, a + chunk))
        plain_s += dt
        got = [t[a:a + chunk] for t in kernel_out]
        ok = ok and all(torch.equal(x, y) for x, y in zip(got, want))
        worst = max(worst, max_abs_err(got, want))
        del want, got
    return ok, worst, plain_s


def kv_path(T, KV, P_layers, ops, RQ, DQ, BF, batch: int, seed: int, dev) -> tuple[dict, list]:
    """Phase 7: the KV store at llama3-8b width; returns the stats and the
    three kernels' rows."""
    caches = kv_caches(P_layers, batch, seed, dev)
    prefill = caches["groups"]["pos0"]["self"]
    recs = [Recorder(ops, "residual_quant"), Recorder(ops, "dequant"), Recorder(ops, "base_fit")]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    try:
        promoted, t_promote = sync_time(lambda: KV.promote_caches(caches, KV_MAX_SEQ))
        cache = promoted["groups"]["pos0"]["self"]
        del caches, prefill
        qkv, t_quant = sync_time(lambda: KV.quantize_cache(cache))
        back, t_dequant = sync_time(lambda: KV.dequantize_cache(qkv))
        launches = dict(ops.launches)
    finally:
        for rec in recs:
            rec.restore()
    for name in ("residual_quant", "dequant", "base_fit"):
        check(launches[name] > 0, f"kernel {name} was not launched on the KV-store path")
    peak = torch.cuda.max_memory_allocated()
    check(tuple(cache.k.shape) == (KV_LAYERS, batch, KV_MAX_SEQ, KV_HEADS, KV_DIM),
          f"promoted K has shape {tuple(cache.k.shape)}")
    check(int(cache.kpos[..., KV_PREFILL:].max()) == -1, "promoted kpos slots are not empty")
    check(back.k.dtype == torch.bfloat16 and back.k.shape == cache.k.shape, "dequantized K")
    check(torch.equal(back.kpos, cache.kpos), "dequantized kpos differs")
    bits = qkv.memory_bits()
    bf16_bits = (cache.k.numel() + cache.v.numel()) * 16 + cache.kpos.numel() * 32
    del back
    # residual_quant against its plain version, on the path's own inputs (K)
    (xb, theta, slope, step), kw = recs[0].args
    m = xb.shape[0]
    got = RQ.residual_quant_cuda(xb, theta, slope, step, **kw)
    check(torch.equal(got[0], qkv.k.q), "residual_quant rerun differs from the path's q")
    ok, err_rq, plain_rq = chunked_equal(got, lambda a, b: RQ.residual_quant_plain(
        xb[a:b], theta[a:b], slope[a:b], step[a:b], **kw), m)
    check(ok, f"residual_quant kernel differs from its plain version (max err {err_rq})")
    del got
    ms_rq = event_ms(lambda: RQ.residual_quant_cuda(xb, theta, slope, step, **kw), 5)
    # dequant against its plain version, on the path's own inputs (K)
    (dq, dth, dsl, dst), _ = recs[1].args
    out = DQ.dequant_cuda(dq, dth, dsl, dst)
    ok, err_dq, plain_dq = chunked_equal([out], lambda a, b: [DQ.dequant_plain(
        dq[a:b], dth[a:b], dsl[a:b], dst[a:b])], m)
    check(ok, f"dequant kernel differs from its plain version (max err {err_dq})")
    ms_dq = event_ms(lambda: DQ.dequant_cuda(dq, dth, dsl, dst), 5)
    # base_fit against its plain version, on the path's own input (K's
    # blocks); float32 bits, so the signs of zeros count too
    (fxb,), _ = recs[2].args
    check(fxb.data_ptr() == xb.data_ptr(), "base_fit's recorded input is not K's blocks")
    fit = BF.base_fit_cuda(xb)
    check(torch.equal(fit[1].to(torch.bfloat16), qkv.k.slope.reshape(-1)),
          "base_fit rerun differs from the path's slope")
    ok, err_fit, plain_fit = chunked_equal(
        [t.view(torch.int32) for t in fit],
        lambda a, b: [t.view(torch.int32) for t in BF.base_fit_plain(xb[a:b])], m)
    check(ok, f"base_fit kernel differs from its plain version (max bit diff {err_fit})")
    del fit
    ms_fit = event_ms(lambda: BF.base_fit_cuda(xb), 5)
    fit_graph_ms = graph_ms(lambda: BF.base_fit_cuda(xb), 20)
    # the float32 reconstruction is within half a step of each input
    # element, plus float32 rounding: r = x - pred, q * step, the
    # reciprocal and x_hat itself each round by at most half an ulp of a
    # value no larger than qmax * step or |x| (four half-ulps: 2**-21)
    ratio, worst = 0.0, 0.0
    qmax = kw["qmax"]
    for a in range(0, m, KV_CHUNK_ROWS):
        b = a + KV_CHUNK_ROWS
        d = (out[a:b] - xb[a:b]).abs()
        ratio = max(ratio, float((d / (0.5 * step[a:b])).max()))
        bound = 0.5 * step[a:b] + 2.0**-21 * (qmax * step[a:b] + xb[a:b].abs())
        worst = max(worst, float((d / bound).max()))
    check(worst <= 1.0, f"KV reconstruction error {worst} of its bound ({ratio} half-steps)")
    del out
    # bf16 theta/slope of the card against the CPU route, on 64-row blocks
    starts = torch.linspace(0, m - 64, 64).long().div(8, rounding_mode="floor").mul(8).tolist()
    rows = torch.cat([torch.arange(a, a + 64) for a in starts]).to(dev)
    th_c, sl_c = T.linear_base_fit(xb[rows].cpu())
    differ = int(((th_c.to(torch.bfloat16) != qkv.k.theta[rows].cpu())
                  | (sl_c.to(torch.bfloat16) != qkv.k.slope[rows].cpu())).sum())
    # stage times of quantize_cache's stages on the same inputs
    (th_f, sl_f), fit_s = sync_time(lambda: T.linear_base_fit(xb))
    _, step_s = sync_time(lambda: T._default_step(xb, th_f, sl_f, qmax))
    del th_f, sl_f
    n_el, n_rows = xb.numel(), xb.shape[0]
    rq_bytes = n_el * (4 + 1 + 4) + n_rows * 12
    dq_bytes = n_el * (1 + 4) + n_rows * 12
    rq_ops, dq_ops = 10 * n_el, 4 * n_el
    fit_bytes, fit_ops = n_el * 4 + n_rows * 8, 3 * n_el  # x read; theta, slope written
    rows_out = [
        kernel_row("residual_quant", "src/repro_torch/kernels/csrc/residual_quant.cu",
                   "src/repro/kernels/residual_quant.py:38", launches, err_rq, ms_rq,
                   plain_rq * 1e3, rq_bytes, rq_ops, F32_OPS_PER_S, [m, xb.shape[1]]),
        kernel_row("dequant", "src/repro_torch/kernels/csrc/dequant.cu",
                   "src/repro/kernels/dequant.py:20", launches, err_dq, ms_dq,
                   plain_dq * 1e3, dq_bytes, dq_ops, F32_OPS_PER_S, [m, xb.shape[1]]),
        kernel_row("base_fit", "src/repro_torch/kernels/csrc/base_fit.cu",
                   "src/repro/core/jaxshrink.py:67", launches, err_fit, ms_fit,
                   plain_fit * 1e3, fit_bytes, fit_ops, F32_OPS_PER_S, [m, xb.shape[1]]),
    ]
    rows_out[-1]["graph_ms"] = fit_graph_ms
    stats = {
        "shape": list(cache.k.shape), "blocks_per_tensor": m,
        "promote_s": t_promote, "quantize_cache_s": t_quant, "dequantize_cache_s": t_dequant,
        "fit_s_one_tensor": fit_s, "default_step_s_one_tensor": step_s,
        "memory_bits": bits, "bf16_bits": bf16_bits, "memory_ratio": bf16_bits / bits,
        "max_err_over_half_step": ratio, "max_err_over_bound": worst,
        "sampled_rows": len(rows),
        "bf16_theta_slope_rows_differing_from_cpu": differ,
        "max_memory_allocated_bytes": peak, "launches": launches,
    }
    return stats, rows_out


def ladder_bounds(xb, recons, err, steps32) -> dict:
    """The ladder's reconstructions against their input, over row passes:
    prefix k within steps[k] / 2 of x plus float32 rounding, its worst
    error no larger than prefix k - 1's, and the full stack's x - recon
    equal to err up to the same rounding.  The rounding: the line, the
    sums of the reconstruction and the quantizer's running error round
    at most ~16 times by half an ulp of a value no larger than |x| +
    |x - pred| + qmax * steps[0] (2**-20 of 2|x| + 2 qmax steps[0])."""
    m = xb.shape[0]
    top = 2 * SURF_QMAX * float(steps32[0])
    worst = [0.0] * len(recons)
    half_steps = [0.0] * len(recons)
    stack = 0.0
    for a in range(0, m, SURF_CHUNK_ROWS):
        b = a + SURF_CHUNK_ROWS
        x = xb[a:b]
        slack = 2.0**-20 * (2 * x.abs() + top)
        for k, recon in enumerate(recons):
            d = (x - recon[a:b]).abs()
            worst[k] = max(worst[k], float(d.max()))
            half_steps[k] = max(half_steps[k], float(d.max()) / (0.5 * float(steps32[k])))
            check(bool((d <= 0.5 * steps32[k] + slack).all()),
                  f"ladder prefix {k}: |x - recon| above steps[{k}] / 2 plus rounding")
        gap = (x - recons[-1][a:b] - err[a:b]).abs()
        stack = max(stack, float(gap.max()))
        check(bool((gap <= slack).all()), "ladder: x - recon of the full stack is not err")
    for k in range(1, len(worst)):
        check(worst[k] <= worst[k - 1], f"ladder prefix {k}: error {worst[k]} grew from "
                                        f"{worst[k - 1]}")
    return {"max_abs_err": worst, "max_err_over_half_step": half_steps,
            "max_abs_x_minus_recon_minus_err": stack}


def surface_path(ops, T, RQ, DQ, IS, P_layers, serve, batch: int, series: int, samples: int,
                 seed: int, dev) -> tuple[dict, list]:
    """Phase 10: the kernel surface ``ops.{pyramid_quant, pyramid_reconstruct,
    interval_stats}`` (the reference's ``repro.kernels.ops`` is their only
    entry point) on data of the port's own paths: the KV store's K of phase
    7 before promotion, cut into the tensor codec's blocks, and the
    streamed gateway's series of phase 8.  Returns the stats and the three
    kernels' rows."""
    k = kv_caches(P_layers, batch, seed, dev)["groups"]["pos0"]["self"].k
    xb, _ = T._blockify(k, T.TensorCodecConfig().block)  # [M, 256] float32
    del k
    xs = torch.as_tensor(serve.sensor_values(series, samples, seed), device=dev).T.contiguous()
    xs_by = {torch.float64: xs, torch.float32: xs.float(), torch.bfloat16: xs.to(torch.bfloat16)}
    m, n = xb.shape
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    theta, slope = (p[:, None] for p in ops.base_fit(xb))
    t = torch.arange(n, dtype=xb.dtype, device=dev)[None, :]
    peak = max(float((xb[a:a + SURF_CHUNK_ROWS] - (theta[a:a + SURF_CHUNK_ROWS]
                      + slope[a:a + SURF_CHUNK_ROWS] * t)).abs().max())
               for a in range(0, m, SURF_CHUNK_ROWS))
    s = peak / SURF_QMAX  # no layer clips
    steps = torch.tensor([s * f for f in SURF_STEP_FRACTIONS], dtype=torch.float64, device=dev)
    (qs, err), pq_s = sync_time(lambda: ops.pyramid_quant(xb, theta, slope, steps, SURF_QMAX))
    recons = [ops.pyramid_reconstruct(qs[: j + 1], theta, slope, steps[: j + 1])
              for j in range(len(SURF_STEP_FRACTIONS))]
    stats_out = {dt: ops.interval_stats(x, SURF_WINDOW) for dt, x in xs_by.items()}
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    for name in ("pyramid_quant", "pyramid_reconstruct", "interval_stats"):
        check(launches[name] > 0, f"kernel {name} was not launched on the kernel-surface path")
    steps32 = steps.float()
    bounds = ladder_bounds(xb, recons, err, steps32)

    # each kernel against its plain version, bit for bit, over row passes
    ok, err_pr, plain_pr = True, 0.0, 0.0
    for j, recon in enumerate(recons):
        same, e, dt = chunked_equal(
            [recon.view(torch.int32)],
            lambda a, b: [DQ.pyramid_reconstruct_plain(qs[: j + 1, a:b], theta[a:b], slope[a:b],
                                                        steps[: j + 1]).view(torch.int32)],
            m, SURF_CHUNK_ROWS)
        ok, err_pr = ok and same, max(err_pr, e)
        plain_pr = dt  # the last pass is the full stack, the one timed below
    check(ok, f"pyramid_reconstruct kernel differs from its plain version (max bit diff {err_pr})")
    del recons

    def pq_plain_rows(a, b):
        q, e = RQ.pyramid_quant_plain(xb[a:b], theta[a:b], slope[a:b], steps, SURF_QMAX)
        return [*q, e.view(torch.int32)]

    ok, err_pq, plain_pq = chunked_equal([*qs, err.view(torch.int32)], pq_plain_rows, m,
                                         SURF_CHUNK_ROWS)
    check(ok, f"pyramid_quant kernel differs from its plain version (max diff {err_pq})")
    del qs, err
    ms_pq = event_ms(lambda: RQ.pyramid_quant_cuda(xb, theta, slope, steps, SURF_QMAX), 5)
    qs, _ = RQ.pyramid_quant_cuda(xb, theta, slope, steps, SURF_QMAX)
    ms_pr = event_ms(lambda: DQ.pyramid_reconstruct_cuda(qs, theta, slope, steps), 5)
    del qs
    # interval_stats in each dtype: bits equal to the plain version's (NaNs
    # and the signs of zeros count); its time, the plain version's and
    # torch.aminmax's over the same windows (timed only, never on the path)
    ts, ss = xs.shape
    nw = ts // SURF_WINDOW
    by_dtype = {}
    for dt, x in xs_by.items():
        want, plain_s = sync_time(lambda: IS.interval_stats_plain(x, SURF_WINDOW))
        got = stats_out[dt]
        err_is = max_abs_err(got, want)
        check(same_bits(got, want), f"interval_stats {dt} differs from its plain version "
                                    f"(max err {err_is})")
        lib = torch.aminmax(x.view(nw, SURF_WINDOW, ss), dim=1)
        check(torch.equal(lib.min, got[0]) and torch.equal(lib.max, got[1]),
              f"interval_stats {dt} differs from torch.aminmax")
        nbytes = (x.numel() + 2 * nw * ss) * x.element_size()  # x read; mins, maxs written
        by_dtype[dt] = {
            "max_abs_err": err_is,
            "ms": event_ms(lambda: IS.interval_stats_cuda(x, SURF_WINDOW), 20),
            "plain_ms": plain_s * 1e3,
            "library_ms": event_ms(lambda: torch.aminmax(x.view(nw, SURF_WINDOW, ss), dim=1), 20),
            # device time alone: a call's host overhead is near the kernel's time
            "graph_ms": graph_ms(lambda: IS.interval_stats_cuda(x, SURF_WINDOW), 20),
            "library_graph_ms": graph_ms(
                lambda: torch.aminmax(x.view(nw, SURF_WINDOW, ss), dim=1), 20),
            "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
            "bound_by": "bytes",
        }
    print("interval_stats: " + json.dumps({
        name: {"ms": r["ms"], "previous_ms": INTERVAL_PREV_MS[name],
               "library_ms": r["library_ms"], "graph_ms": r["graph_ms"],
               "library_graph_ms": r["library_graph_ms"], "bound_ms": r["bound_ms"]}
        for name, r in ((str(dt).replace("torch.", ""), r) for dt, r in by_dtype.items())}),
        flush=True)
    peak_mem = torch.cuda.max_memory_allocated()

    n_el, layers = xb.numel(), len(SURF_STEP_FRACTIONS)
    # pyramid_quant: x read, theta/slope/steps read, L int32 planes and err
    # written; a division, a rounding, two clips, a multiply and a subtract
    # a layer after the line's three operations
    pq_bytes = n_el * (4 + 4 * layers + 4) + m * 8 + layers * 4
    pq_ops = n_el * (3 + 6 * layers)
    # pyramid_reconstruct of the full stack: L int32 planes read, x_hat written
    pr_bytes = n_el * (4 * layers + 4) + m * 8 + layers * 4
    pr_ops = n_el * (2 + 2 * layers)
    is64 = by_dtype[torch.float64]
    is_bytes = xs.numel() * 8 + 2 * nw * ss * 8  # x read once; mins and maxs written
    is_ops = 2 * xs.numel()  # a comparison for the min and one for the max
    rows = [
        kernel_row("pyramid_quant", "src/repro_torch/kernels/csrc/pyramid_quant.cu",
                   "src/repro/kernels/residual_quant.py:56", launches, err_pq, ms_pq,
                   plain_pq * 1e3, pq_bytes, pq_ops, F32_OPS_PER_S, [m, n]),
        kernel_row("pyramid_reconstruct", "src/repro_torch/kernels/csrc/pyramid_reconstruct.cu",
                   "src/repro/kernels/dequant.py:30", launches, err_pr, ms_pr,
                   plain_pr * 1e3, pr_bytes, pr_ops, F32_OPS_PER_S, [layers, m, n]),
        kernel_row("interval_stats", "src/repro_torch/kernels/csrc/interval_stats.cu",
                   "src/repro/kernels/interval_stats.py:20", launches, is64["max_abs_err"],
                   is64["ms"], is64["plain_ms"], is_bytes, is_ops, FP64_OPS_PER_S, [ts, ss]),
    ]
    rows[0].update(dtype="float32", layers=layers, qmax=SURF_QMAX)
    rows[1].update(dtype="float32", note="time and bound of the full stack (L = 3)")
    rows[2].update(dtype="float64", window=SURF_WINDOW, library_ms=is64["library_ms"],
                   library="torch.aminmax(x.view(T // W, W, S), dim=1)",
                   by_dtype={str(dt).replace("torch.", ""): r for dt, r in by_dtype.items()})
    stats = {
        "kv_blocks": [m, n], "gateway_series": [ts, ss], "window": SURF_WINDOW,
        "steps": steps32.tolist(), "pyramid_quant_s": pq_s, **bounds,
        "max_memory_allocated_bytes": peak_mem, "launches": launches,
    }
    return stats, rows


def kernel_row(name, source, replaces, launches, err, ms, plain_ms, nbytes, nops, peak, shape):
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, nops / peak
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches[name], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": 1e3 * max(by_bytes, by_ops),
        "bound_by": "bytes" if by_bytes >= by_ops else "operations",
        "library_ms": None, "shape": shape,
    }


def stream_gateway(P, v: np.ndarray, series, cfg, tiers, dev):
    """Chunk-interleaved ingest of the rows ``series`` of v into a SHRKS
    container on ``dev``, with the value range of all of v pinned; returns
    (the codec, the container)."""
    sc = P.ShrinkStreamCodec(cfg, tiers, decimals=DECIMALS, backend="rans",
                             value_range=(float(v.min()), float(v.max())),
                             frame_len=GW_FRAME, device=dev)
    for c0 in range(0, v.shape[1], GW_CHUNK):
        for sid in series:
            sc.ingest(v[sid, c0 : c0 + GW_CHUNK], series_id=sid)
    return sc, sc.finalize()


BITS = {torch.float64: torch.int64, torch.float32: torch.int32, torch.bfloat16: torch.int16}


def same_bits(got, want) -> bool:
    def bits(t):
        return t.view(BITS.get(t.dtype, t.dtype))

    return all(a.shape == b.shape and torch.equal(bits(a), bits(b)) for a, b in zip(got, want))


def container_segments(P, Sz, blob: bytes):
    """(t0s, lens, thetas, slopes) of every frame of the container, each
    frame's segments in order, as numpy arrays."""
    from repro_torch.core.base import _flat_segments

    metas, _ = Sz.parse_framed_container(blob)
    return metas, [_flat_segments(P.cs_from_bytes(Sz.frame_payload(blob, m)).base)
                   for m in metas]


def check_segment_agg(SA, ops, frames, dev) -> dict:
    """``segment_agg``, the row kernel, through ``ops.segment_agg`` as the
    reference's kernel surface calls it: one launch over every segment of
    the container (a = 0, b = length), counted; then against its plain
    version in float64 and float32 on the same rows, timed."""
    lens = np.concatenate([f[1] for f in frames]).astype(np.float64)
    rows = [torch.as_tensor(x, device=dev).reshape(-1, 1)
            for x in (np.concatenate([f[2] for f in frames]),
                      np.concatenate([f[3] for f in frames]), np.zeros_like(lens), lens)]
    ops.reset_launches()
    ops.segment_agg(*rows)
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    check(launches["segment_agg"] == 1, "kernel segment_agg was not launched by its surface call")
    res = {}
    for dtype in (torch.float64, torch.float32):
        cols = [x.to(dtype) for x in rows]
        got = SA.segment_agg_cuda(*cols)
        want, plain_s = sync_time(lambda: SA.segment_agg_plain(*cols))
        err = max_abs_err(got, want)
        check(same_bits(got, want),
              f"segment_agg {dtype} differs from its plain version on every segment (max err {err})")
        res[dtype] = (err, event_ms(lambda: SA.segment_agg_cuda(*cols), 20), plain_s * 1e3)
    m = rows[0].shape[0]
    err, ms, plain_ms = res[torch.float64]
    kernel_ms = profiled_kernel_ms(lambda: SA.segment_agg_cuda(*rows), "segment_agg_f64")
    # a row: four float64 scalars read, four written; ~40 float64 operations
    row = kernel_row("segment_agg", "src/repro_torch/kernels/csrc/segment_agg.cu",
                     "src/repro/kernels/segment_agg.py:37", launches, err, ms, plain_ms,
                     64 * m, 40 * m, FP64_OPS_PER_S, [m, 1])
    row.update({"dtype": "float64", "kernel_device_ms": kernel_ms,
                "graph_ms": graph_ms(lambda: SA.segment_agg_cuda(*rows), 20),
                "path": "kernel surface (ops.segment_agg over every segment of the container)",
                "f32_max_abs_err": res[torch.float32][0], "f32_ms": res[torch.float32][1],
                "f32_plain_ms": res[torch.float32][2]})
    return row


def profiled_kernel_ms(fn, name: str, reps: int = 20) -> float | None:
    """The device time of the kernels whose name holds ``name``, a call,
    from torch.profiler over ``reps`` calls (None if it saw none)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages() if name in e.key) / reps
    return us / 1e3 or None


class StepRecorder(Recorder):
    """A :class:`Recorder` of ``ops.segment_query`` that keeps the call
    with the most parts."""

    def __call__(self, *args, **kwargs):
        if self.args is None or args[1].shape[0] > self.args[0][1].shape[0]:
            self.args = (args, kwargs)
        return self.orig(*args, **kwargs)


def step_bytes(desc: np.ndarray, parts, mode: str, nrows: int) -> int:
    """The bytes a step must move: its descriptors, the table rows it
    touches (t0, len, theta, slope) and its output buffer."""
    from repro_torch.kernels import segment_agg as SA

    rows = sum(i1 - i0 for i0, i1, *_ in parts)
    return desc.nbytes + 32 * rows + 8 * (SA.HEADER_WORDS * len(desc)
                                          + SA.MODES[mode][1] * nrows)


def check_segment_query(SA, ops, largest, frames, an_launches: dict, dev) -> dict:
    """``segment_query``, the fused step, against its plain version: on the
    analytics run's largest step (as recorded) and on one query over every
    frame of the container in each mode (whole frames; thresholds at each
    frame's first prediction), the output buffers read back part by part
    and equal bit for bit.  Timed on the every-frame query: the kernel
    (profiler), a wrapper call (events; CUDA graph), the whole host step
    (descriptors up, launch, one copy back and one sync) and the plain
    version."""
    (tabs, desc, mode, op, nrows), _ = largest
    want = SA.segment_query_plain(tabs, desc, mode, op, nrows)
    got = SA.segment_query_cuda(tabs, desc, mode, op, nrows)
    dh = desc.cpu().numpy()
    g, w = (SA.query_parts(x.cpu().numpy(), dh, mode, nrows) for x in (got, want))
    check(all(a[:4] == b[:4] and np.array_equal(a[4].view(np.int64), b[4].view(np.int64))
              for a, b in zip(g, w)),
          f"segment_query differs from its plain version on the path's largest step ({mode})")
    largest_parts = len(dh)
    tables = [SA.pack_table(*(torch.as_tensor(x, device=dev) for x in f)) for f in frames]
    d = np.zeros((len(frames), SA.DESC_WORDS), dtype=np.int64)
    off = 0
    for i, (f, t) in enumerate(zip(frames, tables)):
        n, k = int(f[1].sum()), len(f[0])
        c = np.float64(f[2][0]).view(np.int64)  # the frame's first prediction
        d[i] = (t.data_ptr(), k, 0, n, off, c, (np.float64(f[2][0]) + 1e-3).view(np.int64), 0)
        off += min(k, n)
    desc = torch.as_tensor(d, device=dev)
    res = {}
    for mode in ("aggregate", "central", "count"):
        got = SA.segment_query_cuda(tables, desc, mode, "gt", off)
        want, plain_s = sync_time(lambda: SA.segment_query_plain(tables, desc, mode, "gt", off))
        g, w = (SA.query_parts(x.cpu().numpy(), d, mode, off) for x in (got, want))
        check(all(a[:4] == b[:4] and np.array_equal(a[4].view(np.int64), b[4].view(np.int64))
                  for a, b in zip(g, w)),
              f"segment_query differs from its plain version on every frame ({mode})")
        call = lambda: SA.segment_query_cuda(tables, desc, mode, "gt", off)  # noqa: E731
        res[mode] = {"ms": event_ms(call, 20), "graph_ms": graph_ms(call, 20),
                     "kernel_device_ms": profiled_kernel_ms(call, "segment_query"),
                     "plain_ms": plain_s * 1e3, "bytes": step_bytes(d, g, mode, off)}
    # the whole host step of a query touching every frame, as the engine
    # makes it: host descriptors, one launch, one copy back, one sync
    from repro_torch.core import segment_algebra as PA

    sk = [PA.SegmentTable(n=int(f[1].sum()), t0s=t[0], lens=t[1], thetas=t[2].view(
        torch.float64), slopes=t[3].view(torch.float64)) for f, t in zip(frames, tables)]
    parts = [(tab, 0, tab.n) for tab in sk]
    PA.aggregate_parts(parts)
    t0 = time.perf_counter()
    for _ in range(5):
        PA.aggregate_parts(parts)
    step_s = (time.perf_counter() - t0) / 5
    one = [(sk[0], 0, sk[0].n)]
    t0 = time.perf_counter()
    for _ in range(50):
        PA.aggregate_parts(one)
    one_s = (time.perf_counter() - t0) / 50
    agg = res["aggregate"]
    row = kernel_row("segment_query", "src/repro_torch/kernels/csrc/segment_agg.cu",
                     "src/repro/kernels/segment_agg.py:37", an_launches, 0.0, agg["ms"],
                     agg["plain_ms"], agg["bytes"], 40 * sum(i1 - i0 for i0, i1, *_ in g),
                     FP64_OPS_PER_S, [len(frames), SA.DESC_WORDS])
    row.update({"graph_ms": agg["graph_ms"], "kernel_device_ms": agg["kernel_device_ms"],
                "modes": res, "parts": len(frames), "rows": int(sum(len(f[0]) for f in frames)),
                "largest_path_step_parts": largest_parts,
                "host_step_ms_every_frame": step_s * 1e3, "host_step_ms_one_frame": one_s * 1e3})
    return row


KINDS = ("sketch_aggregate", "tiered_aggregate", "count_where")


def by_kind(ops, eng, run, sync_debug: bool):
    """Run ``run()`` with ``eng``'s ``aggregate`` and ``count_where``
    wrapped: per query kind (a zero-decode sketch aggregate, a tiered
    aggregate, a ``count_where``) its queries, ``segment_query`` launches
    and, with ``sync_debug``, synchronizing CUDA calls (the sync debug
    mode's warnings).  Fails if a query makes more than one launch a
    segment step (two for a stddev).  Returns (run's result, the counts)."""
    import warnings

    counts = {k: {"queries": 0, "segment_launches": 0, "syncs": 0} for k in KINDS}
    seen: list = []

    def wrap(name, fn):
        def call(*args, **kwargs):
            kind = "count_where" if name == "count_where" else (
                "sketch_aggregate" if kwargs.get("eps") is None else "tiered_aggregate")
            l0, s0 = ops.launches["segment_query"], len(seen)
            out = fn(*args, **kwargs)
            dl = ops.launches["segment_query"] - l0
            limit = 2 if name == "aggregate" and args[1] == "stddev" else 1
            check(dl <= limit, f"{kind} {args}: {dl} segment_query launches (at most {limit})")
            c = counts[kind]
            c["queries"] += 1
            c["segment_launches"] += dl
            c["syncs"] += sum("synchroniz" in str(w.message) for w in seen[s0:])
            return out
        return call

    eng.aggregate = wrap("aggregate", eng.aggregate)
    eng.count_where = wrap("count_where", eng.count_where)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        seen = caught
        if sync_debug:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            out = run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    for c in counts.values():
        q = max(c["queries"], 1)
        c["segment_launches_per_query"] = c["segment_launches"] / q
        if sync_debug:
            c["syncs_per_query"] = c["syncs"] / q
        else:
            del c["syncs"]
    return out, counts


def cprofile_top(job, top: int = 20) -> dict:
    """Run ``job`` under cProfile; the ``top`` host functions by cumulative
    seconds, as "file:line:function"."""
    import cProfile
    import pstats

    pr = cProfile.Profile()
    pr.enable()
    job()
    torch.cuda.synchronize()
    pr.disable()
    stats = sorted(pstats.Stats(pr).stats.items(), key=lambda kv: -kv[1][3])[:top]
    return {f"{f[0].rsplit('/', 1)[-1]}:{f[1]}:{f[2]}": st[3] for f, st in stats}


def profile_streamed(P, serve, AnalyticsEngine, RangeQueryBatcher, v, cfg, tiers, blob,
                     dev, out_dir: pathlib.Path) -> dict:
    """Phase 8 under ``--trace``: the ingest of an eighth of the sensors and
    128 analytics queries on a fresh engine, each run twice: once under
    torch.profiler (device busy share, top device ops, a Chrome trace in
    ``out_dir``) and once under cProfile (the host functions with the most
    cumulative time)."""
    from torch.profiler import ProfilerActivity, profile

    sub = range(0, v.shape[0], 8)
    jobs = {
        "ingest_eighth": lambda: stream_gateway(P, v, sub, cfg, tiers, dev),
        "analytics_128": lambda: serve.analytics_traffic(
            AnalyticsEngine(RangeQueryBatcher(blob, cache_frames=GW_CACHE, device=dev)),
            v, 128, GW_FRAME, tiers, seed=GW_QUERY_SEED),
    }
    out_dir.mkdir(parents=True, exist_ok=True)
    res = {}
    for name, job in jobs.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall0 = time.perf_counter()
            job()
            torch.cuda.synchronize()
            wall = time.perf_counter() - wall0
        path = out_dir / f"streamed_{name}_trace.json"
        prof.export_chrome_trace(str(path))
        busy_ms, ops_ms = device_busy(path)
        res[name] = {
            "wall_s": wall, "device_busy_ms": busy_ms, "device_busy_share": busy_ms / 1e3 / wall,
            "top_device_ops": dict(sorted(ops_ms.items(), key=lambda kv: -kv[1]["device_ms"])[:8]),
            "host_cumulative_s": cprofile_top(job),
        }
    (out_dir / "streamed_trace_summary.json").write_text(json.dumps(res, indent=1))
    return res


def streamed_path(P, SA, series: int, samples: int, range_queries: int,
                  analytics_queries: int, seed: int, dev,
                  trace_dir: pathlib.Path | None = None) -> tuple[dict, dict]:
    """Phase 8: streamed gateway ingest, range serving and analytics;
    returns the stats and the ``segment_query`` and ``segment_agg`` rows."""
    from repro_torch.analytics import AnalyticsEngine
    from repro_torch.core import serialize as Sz
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serving import RangeQueryBatcher

    v = serve.sensor_values(series, samples, seed)
    s, n = v.shape
    vrng = float(v.max() - v.min())
    cfg = P.ShrinkConfig(eps_b=0.02 * vrng, lam=1e-4)
    tiers = [1e-2 * vrng, 1e-3 * vrng, 0.0]
    ops.reset_launches()
    (sc, blob), t_ingest = sync_time(lambda: stream_gateway(P, v, range(s), cfg, tiers, dev))
    ingest_launches = dict(ops.launches)
    check(ingest_launches["rans_encode"] > 0, "kernel rans_encode was not launched by the ingest")
    st = sc.stats()
    check(st["samples_sealed"] == s * n, f"sealed {st['samples_sealed']} of {s * n} samples")
    stats = {
        "series": s, "samples": s * n, "frames": st["frames"], "ingest_s": t_ingest,
        "samples_per_s": s * n / t_ingest, "container_bytes": len(blob),
        "compression_ratio": P.BYTES_PER_ROW * s * n / len(blob),
        "kb_entries": st["kb"]["entries"], "kb_bytes": len(sc.kb.to_bytes()),
        "backends": st["backends"], "ingest_launches": ingest_launches,
    }
    print("streamed gateway: " + json.dumps(stats), flush=True)
    del sc

    # the CPU route: the same container for 8 of the series
    pick = list(range(0, s, max(s // GW_CPU_SERIES, 1)))[:GW_CPU_SERIES]
    _, card8 = stream_gateway(P, v, pick, cfg, tiers, dev)
    _, cpu8 = stream_gateway(P, v, pick, cfg, tiers, "cpu")
    check(card8 == cpu8, "streamed container: CPU route bytes differ from the card's")
    full = {(m.series_id, m.t_lo): Sz.frame_payload(blob, m)
            for m in Sz.parse_framed_container(blob)[0]}
    check(all(full[(m.series_id, m.t_lo)] == Sz.frame_payload(card8, m)
              for m in Sz.parse_framed_container(card8)[0]),
          "frame payloads of the 8-series container differ from the full container's")
    stats["cpu_route_series"] = pick

    # range serving
    eps = 1e-3 * vrng
    batcher = RangeQueryBatcher(blob, cache_frames=GW_CACHE, device=dev)
    ops.reset_launches()
    rres = serve.range_traffic(batcher, v, range_queries, GW_FRAME, eps, seed=GW_QUERY_SEED)
    range_launches = dict(ops.launches)
    check(rres["failed"] == 0, f"range serving: {rres['failed']} queries failed or missed eps")
    check(range_launches["rans_decode"] > 0, "kernel rans_decode was not launched by range serving")
    rng_stats = {**rres, "q_per_s": rres["queries"] / rres["seconds"], "eps": eps,
                 "frames_decoded": batcher.stats["frames_decoded"],
                 "cache_hits": batcher.stats["frame_hits"],
                 "layers_decoded": batcher.stats["layers_decoded"],
                 "layer_hits": batcher.stats["layer_hits"], "launches": range_launches}
    print("range serving: " + json.dumps(rng_stats), flush=True)
    del batcher

    # analytics, with segment_query's largest step recorded and each
    # query's segment steps counted by kind
    rec = StepRecorder(ops, "segment_query")
    eng = AnalyticsEngine(RangeQueryBatcher(blob, cache_frames=GW_CACHE, device=dev))
    try:
        ops.reset_launches()
        ares, an_kinds = by_kind(ops, eng, lambda: serve.analytics_traffic(
            eng, v, analytics_queries, GW_FRAME, tiers, seed=GW_QUERY_SEED), False)
        an_launches = dict(ops.launches)
    finally:
        rec.restore()
    check(ares["failed"] == 0, f"analytics: {ares['failed']} answers missed the truth")
    for name in ("segment_query", "rans_decode"):
        check(an_launches[name] > 0, f"kernel {name} was not launched by the analytics run")
    # the first 64 queries again on fresh engines, each run timed: the card's
    # and the CPU route's answers must be equal; a third run on the card
    # counts its synchronizing calls
    card_ans, cpu_ans = [], []
    eng_c = AnalyticsEngine(RangeQueryBatcher(blob, cache_frames=GW_CACHE, device=dev))
    card64 = serve.analytics_traffic(eng_c, v, GW_CPU_QUERIES, GW_FRAME, tiers,
                                     seed=GW_QUERY_SEED, answers=card_ans)
    eng_h = AnalyticsEngine(blob, cache_frames=GW_CACHE, device="cpu")
    cpu64 = serve.analytics_traffic(eng_h, v, GW_CPU_QUERIES, GW_FRAME, tiers,
                                    seed=GW_QUERY_SEED, answers=cpu_ans)
    check(card64["failed"] == 0 and cpu64["failed"] == 0,
          "analytics: an answer of the 64-query runs missed the truth")
    check([a.__dict__ for a in card_ans] == [a.__dict__ for a in cpu_ans]
          and eng_c.stats == eng_h.stats, "analytics: the CPU route's answers differ from the card's")
    eng_s = AnalyticsEngine(RangeQueryBatcher(blob, cache_frames=GW_CACHE, device=dev))
    _, sync_kinds = by_kind(ops, eng_s, lambda: serve.analytics_traffic(
        eng_s, v, GW_CPU_QUERIES, GW_FRAME, tiers, seed=GW_QUERY_SEED), True)
    syncs = sum(c["syncs"] for c in sync_kinds.values())
    an_stats = {**ares, "q_per_s": ares["queries"] / ares["seconds"], **eng.stats,
                "serving_cache_hits": eng.batcher.stats["frame_hits"],
                "segment_query_launches": an_launches["segment_query"],
                "segment_query_launches_per_query": an_launches["segment_query"] / ares["queries"],
                "segment_launches_by_kind": an_kinds,
                "launches": an_launches, "cpu_route_queries": GW_CPU_QUERIES,
                "first_queries_card_q_per_s": card64["queries"] / card64["seconds"],
                "first_queries_cpu_route_q_per_s": cpu64["queries"] / cpu64["seconds"],
                "syncs_per_query": syncs / GW_CPU_QUERIES, "syncs_by_kind": sync_kinds,
                "syncs_per_query_before": SYNCS_PER_QUERY_PREV}
    print("analytics: " + json.dumps(an_stats), flush=True)
    _, frames = container_segments(P, Sz, blob)
    rows = [check_segment_query(SA, ops, rec.args, frames, an_launches, dev),
            check_segment_agg(SA, ops, frames, dev)]
    out = {"ingest": stats, "range": rng_stats, "analytics": an_stats}
    if trace_dir is not None:
        out["trace"] = profile_streamed(P, serve, AnalyticsEngine, RangeQueryBatcher, v, cfg,
                                        tiers, blob, dev, trace_dir)
        print("streamed trace: " + json.dumps(out["trace"]), flush=True)
    return out, rows


def trace_main_path(P, values: np.ndarray, codec, dev, out_dir: pathlib.Path) -> dict:
    """Stage times of compress_batch and decompress_at (host clock after a
    synchronize, calling the codec's stages in its own order), then one
    profiled compress_batch + lossless decode of 64 series."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import base as B
    from repro_torch.core import phases as Ph
    from repro_torch.core import residuals as Rz
    from repro_torch.core import semantics as Sm
    from repro_torch.core import serialize as Sz
    from repro_torch.kernels import ops

    v = torch.as_tensor(values, device=dev)
    cfg = codec.config
    t: dict[str, float] = {}
    (lv, eps), t["fluctuation_table"] = sync_time(
        lambda: Ph.fluctuation_table(v, v.amax(1) - v.amin(1), cfg))
    scan, t["cone_scan_kernel"] = sync_time(
        lambda: ops.cone_scan(v.T.contiguous(), eps.T.contiguous()))
    _, t["compact_segments"] = sync_time(lambda: ops.compact_segments(*scan))
    del lv, eps, scan
    segs, t["extract_semantics_batch_total"] = sync_time(
        lambda: Sm.extract_semantics_batch(v, cfg))
    vmins, vmaxs = v.amin(1).tolist(), v.amax(1).tolist()
    n = v.shape[1]
    bases, t["construct_base_host"] = sync_time(lambda: [
        B.construct_base(segs[i], n, vmins[i], vmaxs[i], cfg) for i in range(len(segs))])
    _, t["encode_base_host"] = sync_time(lambda: [Sz.encode_base(b) for b in bases])
    preds, t["base_predictions_batch"] = sync_time(lambda: B.base_predictions_batch(bases, dev))
    tiers = Rz.normalize_tiers(TIERS, DECIMALS)
    streams, t["quantize_pyramid_batch"] = sync_time(
        lambda: Rz.quantize_pyramid_batch(v, preds, tiers, DECIMALS))
    todo = [st for row in streams for st in row if st is not None]
    _, t["entropy_encode"] = sync_time(lambda: Rz.encode_residuals_batch(todo))
    css, t["compress_batch_total"] = sync_time(
        lambda: codec.compress_batch(v, TIERS, decimals=DECIMALS))
    blobs = [P.cs_to_bytes(cs) for cs in css[:64]]
    parsed, t["cs_from_bytes_64"] = sync_time(lambda: [P.cs_from_bytes(b) for b in blobs])
    _, t["decompress_at_lossless_64"] = sync_time(
        lambda: [codec.decompress_at(cs, 0.0) for cs in parsed])
    host = cprofile_top(lambda: [codec.decompress_at(cs, 0.0) for cs in parsed])
    del preds, streams, todo, css

    out_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall0 = time.perf_counter()
        css = codec.compress_batch(v, TIERS, decimals=DECIMALS)
        torch.cuda.synchronize()
        wall_c = time.perf_counter() - wall0
        parsed = [P.cs_from_bytes(P.cs_to_bytes(cs)) for cs in css[:64]]
        torch.cuda.synchronize()
        wall1 = time.perf_counter()
        for cs in parsed:
            codec.decompress_at(cs, 0.0)
        torch.cuda.synchronize()
        wall_d = time.perf_counter() - wall1
        wall_all = time.perf_counter() - wall0
    trace_path = out_dir / "main_path_trace.json"
    prof.export_chrome_trace(str(trace_path))
    busy_ms, ops_ms = device_busy(trace_path)
    top = dict(sorted(ops_ms.items(), key=lambda kv: -kv[1]["device_ms"])[:15])
    trace = {
        "stage_s": t,
        "profiled_wall_s": {"compress_batch": wall_c, "cs_from_bytes+decompress_at_64": wall_d,
                            "window": wall_all},
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / 1e3 / wall_all,
        "top_device_ops": top,
        "decompress_at_64_host_cumulative_s": host,
    }
    (out_dir / "main_path_trace_summary.json").write_text(json.dumps(trace, indent=1))
    return trace


DEVICE_EVENTS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_busy(trace_path: pathlib.Path) -> tuple[float, dict]:
    """Device busy time of a torch.profiler Chrome trace: the union over
    time of its kernel, memcpy and memset events (host-side op events are
    left out, so nothing is counted twice), and the device time by event
    name."""
    events = json.loads(trace_path.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    spans, by_name = [], {}
    for e in events:
        if e.get("cat") not in DEVICE_EVENTS or e.get("ph") != "X":
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        spans.append((ts, ts + dur))
        row = by_name.setdefault(e["name"], {"device_ms": 0.0, "calls": 0})
        row["device_ms"] += dur / 1e3
        row["calls"] += 1
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return busy_us / 1e3, by_name


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, dev) for v in tree]
    return tree.to(dev)


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _first(tree, n: int):
    """The first n layers of a stacked params tree."""
    if isinstance(tree, dict):
        return {k: _first(v, n) for k, v in tree.items()}
    return tree[:n]


def logits_agree(want, got, what: str, tol=(0.35, 0.05)) -> dict:
    """Hold logits [..., V] within (atol, rtol) = ``tol`` (by default the
    reference's prefill-vs-decode bound, ``tests/test_models_smoke.py``)
    and at top-1 agreement >= 0.99; a row whose top-1 differs counts
    against the 0.99 unless its reference margin is within twice that row's
    largest difference (a near tie)."""
    want, got = want.float(), got.float()
    atol, rtol = tol
    check(bool(torch.allclose(got, want, atol=atol, rtol=rtol)),
          f"{what}: logits outside atol {atol}, rtol {rtol} "
          f"(max |diff| {float((got - want).abs().max())})")
    same = want.argmax(-1) == got.argmax(-1)
    top2 = want.topk(2, dim=-1).values
    tie = (top2[..., 0] - top2[..., 1]) <= 2 * (got - want).abs().amax(-1)
    agree = float(same.float().mean())
    check(agree >= 0.99 or bool((same | tie).all()),
          f"{what}: top-1 agreement {agree} below 0.99 off near ties")
    return {"max_abs_diff": float((got - want).abs().max()), "top1_agreement": agree,
            "rows": int(same.numel())}


def check_flash(FA, q, k, v, launches: dict) -> dict:
    """The flash kernel against its plain version on layer 0's q, k, v of
    the prefill (bf16), the same in float32, and a length that is not a
    multiple of the 64-row tile; then its time, its plain version's, the
    PyTorch SDPA call's (timed only) and the bound."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    errs = {}
    cases = [("bf16", (q, k, v), FLASH_BF16_TOL), ("f32", (q.float(), k.float(), v.float()),
             FLASH_F32_TOL), ("bf16_len_2000", (q[:, :2000], k[:, :2000], v[:, :2000]),
             FLASH_BF16_TOL)]
    for name, args, tol in cases:
        got = FA.flash_attention_cuda(*args, causal=True)
        want = FA.flash_attention_plain(*args, causal=True)
        errs[name] = float((got.float() - want.float()).abs().max())
        check(bool(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)),
              f"flash_attention {name} differs from its plain version (max err {errs[name]})")
        del got, want
    ms = event_ms(lambda: FA.flash_attention_cuda(q, k, v, causal=True), 10)
    plain_ms = event_ms(lambda: FA.flash_attention_plain(q, k, v, causal=True), 3)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = event_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True), 10)
    pairs = sq * (sq + 1) // 2  # causal (q, k) pairs of a prefill, Sk == Sq
    nops = 4 * b * h * d * pairs  # q k^T and p v, a multiply and an add each
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    row = kernel_row("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
                     "src/repro/kernels/flash_attention.py:31", launches, errs["bf16"], ms,
                     plain_ms, nbytes, nops, BF16_OPS_PER_S, list(q.shape) + [kvh])
    row.update(library_ms=library_ms, library="torch.nn.functional.scaled_dot_product_attention"
               "(is_causal=True, enable_gqa=True)", dtype="bfloat16",
               f32_max_abs_err=errs["f32"], len_2000_max_abs_err=errs["bf16_len_2000"],
               tolerance={"bf16": FLASH_BF16_TOL, "f32": FLASH_F32_TOL},
               fraction_of_bound=row["bound_ms"] / ms, vs_library=ms / library_ms)
    print("flash_attention: " + json.dumps({"ms": ms, "previous_ms": FLASH_PREV_MS,
                                            "library_ms": library_ms,
                                            "bound_ms": row["bound_ms"]}), flush=True)
    return row


def profile_model(m, params, toks, dev, out_dir: pathlib.Path) -> dict:
    """Phase 9 under ``--trace``: one prefill and four decode steps (fresh
    caches of the path's length) under torch.profiler: device busy share,
    top device ops, device events (kernels and copies), a Chrome trace in
    ``out_dir``."""
    from torch.profiler import ProfilerActivity, profile

    b, s = toks.shape
    dec = m.make_decode_caches(b, s + 4, device=dev)
    jobs = {
        "prefill": lambda: m.prefill(params, {"tokens": toks}),
        "decode_4_steps": lambda: [m.decode_step(params, toks[:, :1], dec, s + i)
                                   for i in range(4)],
    }
    out_dir.mkdir(parents=True, exist_ok=True)
    res = {}
    for name, job in jobs.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall0 = time.perf_counter()
            job()
            torch.cuda.synchronize()
            wall = time.perf_counter() - wall0
        path = out_dir / f"model_{name}_trace.json"
        prof.export_chrome_trace(str(path))
        busy_ms, ops_ms = device_busy(path)
        res[name] = {
            "wall_s": wall, "device_busy_ms": busy_ms, "device_busy_share": busy_ms / 1e3 / wall,
            "device_events": sum(r["calls"] for r in ops_ms.values()),
            "top_device_ops": dict(sorted(ops_ms.items(), key=lambda kv: -kv[1]["device_ms"])[:8]),
        }
    (out_dir / "model_trace_summary.json").write_text(json.dumps(res, indent=1))
    return res


def model_path(ops, FA, cfg, batch: int, length: int, steps: int, seed: int, dev,
               trace: pathlib.Path | None = None):
    """Phase 9: a dense model (llama3-8b's full width and depth) on the
    card: prefill, the kernel against its plain version on the path's own
    inputs, prefill -> decode, the CPU route.  Returns (stats, flash row,
    the prefill's logits, the decode's tokens fed, logits and median step
    s), the last two on the host for phase 16."""
    from repro_torch.models import build_model
    from repro_torch.models import transformer as T

    m = build_model(cfg)
    params, init_s = sync_time(lambda: m.init(seed, device=dev))
    n_params = sum(t.numel() for t in _leaves(params))
    g = torch.Generator(device=dev).manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (batch, length), generator=g, device=dev)
    with torch.inference_mode():
        m.prefill(params, {"tokens": toks[:1, :128]})  # warm-up: cuBLAS and the kernel library
        rec = Recorder(ops, "flash_attention")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        try:
            (logits, caches), prefill_s = sync_time(lambda: m.prefill(params, {"tokens": toks}))
            launches = dict(ops.launches)
        finally:
            rec.restore()
        peak = torch.cuda.max_memory_allocated()
        check(launches["flash_attention"] == cfg.n_layers,
              f"prefill launched flash_attention {launches['flash_attention']} times, "
              f"not once a layer ({cfg.n_layers})")
        check(tuple(logits.shape) == (batch, 1, cfg.padded_vocab)
              and bool(torch.isfinite(logits.float()).all()), "prefill logits")
        pc = caches["groups"]["pos0"]["self"]
        check(tuple(pc.k.shape) == (cfg.n_layers, batch, length, cfg.n_kv_heads,
                                    cfg.resolved_head_dim), f"prefill caches {tuple(pc.k.shape)}")
        (q, k, v), _ = rec.args
        row = check_flash(FA, q, k, v, launches)
        del q, k, v, rec

        # prefill -> decode: graft the caches, decode greedily, and hold each
        # step's logits to one forward pass over the extended prompt
        dec = m.make_decode_caches(batch, length + steps, device=dev)
        dc = dec["groups"]["pos0"]["self"]
        dc.k[:, :, :length], dc.v[:, :, :length], dc.kpos[:, :, :length] = pc.k, pc.v, pc.kpos
        del caches, pc
        tok = logits[:, -1].argmax(-1, keepdim=True)
        fed, dec_logits, step_s = [], [], []
        for i in range(steps):
            fed.append(tok)
            (out, dec), dt = sync_time(lambda: m.decode_step(params, tok, dec, length + i))
            step_s.append(dt)
            dec_logits.append(out[:, 0])
            tok = out[:, -1].argmax(-1, keepdim=True)
        del dec
        decoded = {"tokens": [t.cpu() for t in fed], "logits": [t.cpu() for t in dec_logits],
                   "median_step_s": float(np.median(step_s[1:] or step_s))}
        profiled = profile_model(m, params, toks, dev, trace) if trace is not None else None
        ext = torch.cat([toks] + fed, dim=1)
        pos = torch.arange(length + steps, device=dev, dtype=torch.int32)[None].expand(batch, -1)
        x, _, _ = T.apply_stack(params, T.embed_tokens(params, ext, cfg), cfg, mode="train",
                                positions=pos)
        full = T.logits_from(params, x[:, length:], cfg)
        del x
        decode = logits_agree(full, torch.stack(dec_logits, dim=1), "decode after prefill")

        # the CPU route: the embeddings, the head and the first layers, on
        # the CPU (plain versions) and on the card (the kernel)
        sm = build_model(dataclasses.replace(cfg, n_layers=LM_CPU_LAYERS))
        sub = dict(params, groups={"pos0": _first(params["groups"]["pos0"], LM_CPU_LAYERS)})
        short = toks[:1, :LM_CPU_LEN]
        ops.reset_launches()
        card_logits, card_c = sm.prefill(sub, {"tokens": short})
        check(ops.launches["flash_attention"] == LM_CPU_LAYERS, "CPU-route check: launches")
        sub_cpu = _tree_to(sub, "cpu")
        (cpu_logits, cpu_c), cpu_s = sync_time(
            lambda: sm.prefill(sub_cpu, {"tokens": short.cpu()}))
        cpu_route = logits_agree(cpu_logits, card_logits.cpu(), "CPU route", CPU_ROUTE_TOL)
        cpu_route["cache_k_max_abs_diff"] = float(
            (card_c["groups"]["pos0"]["self"].k.cpu().float()
             - cpu_c["groups"]["pos0"]["self"].k.float()).abs().max())
        cpu_route.update(layers=LM_CPU_LAYERS, tokens=LM_CPU_LEN, cpu_prefill_s=cpu_s)
        del sub_cpu, sub, params
    stats = {
        "arch": cfg.name, "params": n_params, "param_bytes": 2 * n_params,
        "init_s": init_s, "batch": batch, "prompt_len": length, "prefill_s": prefill_s,
        "prefill_tokens_per_s": batch * length / prefill_s,
        "max_memory_allocated_bytes": peak, "launches": launches,
        "decode_steps": steps, "decode_s": sum(step_s), "decode_first_step_s": step_s[0],
        "decode_step_median_s": float(np.median(step_s[1:] or step_s)),
        "decode_vs_forward": decode,
        "cpu_route": cpu_route,
    }
    if profiled is not None:
        stats["trace"] = profiled
    return stats, row, logits.cpu(), decoded


def run_main(serve, argv: list[str]) -> str:
    """``serve.main(argv)``, which must exit 0; returns what it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(argv)
    out = buf.getvalue().strip()
    print(out, flush=True)
    check(rc == 0, f"serve {' '.join(argv)} exited {rc}")
    return out


def serve_model_path(serve, arch: str, *extra: str) -> dict:
    """``serve --mode model --arch <arch>`` at the launcher's defaults (and
    any ``extra`` flags), through its ``main``: every request served,
    ``failed=0``; its report line is parsed."""
    out = run_main(serve, ["--mode", "model", "--arch", arch, *extra])
    got = re.search(r"served (\d+) requests, (\d+) tokens, ([\d.]+)s \(([\d.]+) tok/s\), "
                    r"failed=(\d+)", out)
    check(got is not None and int(got.group(5)) == 0, f"serve --mode model: {out}")
    check(int(got.group(1)) == SERVE_REQUESTS, f"serve --mode model served {got.group(1)}")
    return {"requests": int(got.group(1)), "tokens": int(got.group(2)),
            "seconds": float(got.group(3)), "tokens_per_s": float(got.group(4))}


def golden_series() -> np.ndarray:
    t = np.arange(GOLDEN_N, dtype=np.float64)
    v = np.sin(t * 0.02) * 2.5 + 0.3 * np.sign(np.sin(t * 0.15)) + 1e-3 * t
    return np.round(v, GOLDEN_DECIMALS)


def check_golden(P, dev) -> list[str]:
    v = golden_series()
    rng = float(v.max() - v.min())
    codec = P.ShrinkCodec(P.ShrinkConfig(eps_b=0.05 * rng, lam=1e-3), backend="rans", device=dev)
    cases = {
        "golden_v4.shrk": [1e-2, 0.0],
        "golden_v4_pyramid.shrk": [1e-1 * rng, 1e-2 * rng, 1e-3 * rng, 0.0],
    }
    for name, tiers in cases.items():
        blob = (ROOT / "tests" / "golden" / name).read_bytes()
        cs = P.cs_from_bytes(blob)
        out = codec.decompress_at(cs, 0.0)
        check(torch.equal(out.cpu(), torch.as_tensor(v)), f"{name}: lossless decode differs")
        check(P.cs_to_bytes(cs) == blob, f"{name}: parse + re-encode differs")
        check(P.cs_to_bytes(codec.compress(v, tiers, decimals=GOLDEN_DECIMALS)) == blob,
              f"{name}: compress on the card differs from the fixture")
    return sorted(cases)


def launch_delta(ops, before: dict) -> dict:
    return {k: ops.launches[k] - before[k] for k in SERVING_KERNELS}


def serving_ingest(P, ops, serve, dev) -> tuple[dict, list]:
    """Ragged gateway ingest at a gateway's scale: ``ragged_sensor_traffic``
    through one ``RaggedBatcher`` on the card, every series read back in
    ``SERVE_RANGES`` range queries within eps, and the CPU route's bytes
    on a cut of the traffic.  Returns the stats and the cut's series."""
    from repro_torch.data.synthetic import ragged_sensor_traffic
    from repro_torch.serving import RaggedBatcher, RangeQuery, RangeQueryBatcher

    t = time.perf_counter()
    traffic = ragged_sensor_traffic(SERVE_SENSORS, SERVE_TICKS, seed=0)
    gen_s = time.perf_counter() - t

    def batcher(device):
        return RaggedBatcher(P.ShrinkConfig(**SERVE_CONFIG), eps_targets=[SERVE_EPS], backend="rans",
                             flush_samples=SERVE_FLUSH, max_buckets=SERVE_BUCKETS,
                             device=device)

    b = batcher(dev)
    l0 = dict(ops.launches)
    (blob, history), ingest_s = sync_time(lambda: serve.ragged_ingest(b, traffic))
    ingest_launches = launch_delta(ops, l0)
    for name in ("cone_scan", "rans_encode"):
        check(ingest_launches[name] > 0, f"kernel {name} was not launched by the ragged ingest")
    st = b.stats()
    n = st["samples_ingested"]
    stats = {"sensors": SERVE_SENSORS, "ticks": SERVE_TICKS, "samples": n,
             "traffic_gen_s": gen_s, "ingest_s": ingest_s, "samples_per_s": n / ingest_s,
             "frames": st["frames"], "flushes": st["flushes"], "container_bytes": len(blob),
             "compression_ratio": P.BYTES_PER_ROW * n / len(blob),
             "kb_entries": st["kb"]["entries"], "backends": st["backends"],
             "launches": ingest_launches}
    del traffic
    # every series read back within eps: a few range queries a series,
    # each answer read back once
    rq = RangeQueryBatcher(blob, cache_frames=64, device=dev)
    full = {sid: np.concatenate(chunks) for sid, chunks in history.items()}
    for sid, v in full.items():
        edges = np.linspace(0, v.size, SERVE_RANGES + 1).astype(np.int64)
        for lo, hi in zip(edges[:-1], edges[1:]):
            if hi > lo:
                rq.submit(RangeQuery(qid=sid, series_id=sid, t0=int(lo), t1=int(hi),
                                     eps=SERVE_EPS))
    l0 = dict(ops.launches)
    done, decode_s = sync_time(rq.run)
    worst = 0.0
    for q in done:
        check(q.error is None, f"ingest decode check: series {q.series_id}: {q.error}")
        err = float(np.abs(q.result.cpu().numpy() - full[q.series_id][q.t0 : q.t1]).max())
        worst = max(worst, err)
    check(worst <= SERVE_EPS * (1 + 1e-9), f"ingest decode check: error {worst} > {SERVE_EPS}")
    check(sum(q.t1 - q.t0 for q in done) == n, "ingest decode check did not cover every sample")
    stats.update(decode_queries=len(done), decode_s=decode_s, decode_max_abs_err=worst,
                 decode_launches=launch_delta(ops, l0))
    del rq, full, history
    # the CPU route's bytes on a cut of the traffic
    ticks_cut, sensors_cut = SERVE_CUT
    cut = [[(s, c) for s, c in tick if s < sensors_cut]
           for tick in ragged_sensor_traffic(SERVE_SENSORS, ticks_cut, seed=0)]
    card_cut, cut_history = serve.ragged_ingest(batcher(dev), cut)
    cpu_cut, _ = serve.ragged_ingest(batcher("cpu"), cut)
    check(card_cut == cpu_cut, "ragged ingest: the CPU route's container differs from the card's")
    stats["cpu_route_cut"] = {"ticks": ticks_cut, "sensors": sensors_cut,
                              "samples": sum(c.size for tick in cut for _, c in tick),
                              "container_bytes": len(card_cut)}
    archives = [(sid, np.concatenate(cut_history[sid])) for sid in sorted(cut_history)]
    return stats, archives


def kb_store_archives(P, archives, device) -> tuple[list[bytes], list[bytes]]:
    """One ref-mode SHRKS archive a series, written on ``device`` against
    one ``KBStore``; returns the archives and the store's SHKS snapshots
    (``snapshot_to_bytes``), after each archive's ref is resolved."""
    from repro_torch.serving import KBStore, resolve_container_kb

    store = KBStore(P.ShrinkConfig(**SERVE_CONFIG))
    blobs = []
    for sid, v in archives:
        sc = P.ShrinkStreamCodec(P.ShrinkConfig(**SERVE_CONFIG), [SERVE_EPS], backend="rans", kb_store=store,
                                 source=f"sensor{sid}", device=device)
        sc.ingest(v, series_id=sid)
        blobs.append(sc.finalize())
    for blob in blobs:
        check(resolve_container_kb(blob, store)[1] == "store",
              "KB store: an archive's snapshot ref did not resolve")
    return blobs, [snap.blob for snap in store.snapshots]


def serving_kbstore(P, ops, serve, archives, dev) -> dict:
    """The smoke's own ``KBStore`` over the ingest cut's series, written on
    the card and on the CPU route: the archives and the snapshot bytes
    must be equal.  Then ``serve --mode kbstore`` at its defaults on the
    card, which must exit 0 with no mismatch."""
    l0 = dict(ops.launches)
    (card_blobs, card_snaps), card_s = sync_time(lambda: kb_store_archives(P, archives, dev))
    launches = launch_delta(ops, l0)
    cpu_blobs, cpu_snaps = kb_store_archives(P, archives, "cpu")
    check(card_blobs == cpu_blobs and card_snaps == cpu_snaps,
          "KB store: the CPU route's archives or snapshots differ from the card's")
    out, serve_s = sync_time(lambda: run_main(serve, ["--mode", "kbstore"]))
    check("mismatches: 0" in out, "serve --mode kbstore reported mismatches")
    return {"archives": len(card_blobs), "archive_bytes": sum(map(len, card_blobs)),
            "snapshots": len(card_snaps), "last_snapshot_bytes": len(card_snaps[-1]),
            "card_s": card_s, "launches": launches, "serve_kbstore_s": serve_s}


CHAOS_SAME = re.compile(r"^(pristine|phase 1|phase 3)")


def serving_chaos(ops, serve) -> dict:
    """``serve --mode chaos`` at its defaults on the card: no silent
    corruption; the container and the tallies of phases 1 and 3 equal the
    CPU route's (phase 2 runs on the real clock)."""
    outs, secs = [], []
    l0 = dict(ops.launches)
    for argv in (["--mode", "chaos"], ["--mode", "chaos", "--device", "cpu"]):
        out, s = sync_time(lambda: run_main(serve, argv))
        outs.append([re.sub(r" in [\d.]+s", "", ln) for ln in out.splitlines()
                     if CHAOS_SAME.match(ln)])
        secs.append(s)
        check("silent corruptions: 0" in out, f"serve {' '.join(argv)}: silent corruption")
    check(len(outs[0]) == 3 and outs[0] == outs[1],
          "serve --mode chaos: the CPU route's tallies of phases 1 and 3 differ from the card's")
    return {"card_s": secs[0], "cpu_route_s": secs[1], "tallies": outs[0][1:],
            "launches": launch_delta(ops, l0)}


def serving_fleet(ops, serve, seed: int, dev) -> dict:
    """``run_fleet_sim`` with 4 shards on the card: no silent corruption,
    no cross-shard byte mismatch against the 1-shard oracle, the shard-kill
    tail typed or flagged."""
    l0 = dict(ops.launches)
    r = serve.run_fleet_sim(n_shards=FLEET_SHARDS, series=FLEET_SERIES, ticks=FLEET_TICKS,
                            queries=FLEET_QUERIES, flush_samples=FLEET_FLUSH, seed=seed,
                            device=dev)
    r["launches"] = launch_delta(ops, l0)
    check(r["silent"] == 0, f"fleet: {r['silent']} silent corruptions")
    check(r["byte_mismatch"] == 0, f"fleet: {r['byte_mismatch']} cross-shard byte mismatches")
    kill = r["kill"]
    check(kill["fault"] != ""
          and kill["ok"] + kill["degraded"] + kill["error"] == min(FLEET_QUERIES, 64),
          f"fleet: the shard-kill tail did not run: {kill}")
    for name in ("rans_decode", "segment_query"):
        check(r["launches"][name] > 0, f"kernel {name} was not launched by the fleet's queries")
    return r


def serving_path(P, ops, serve, seed: int, dev) -> dict:
    """Phase 11: the serving tier through the port's entry points; each of
    ``SERVING_KERNELS`` must launch inside it."""
    ops.reset_launches()
    (ingest, archives), phase_s = sync_time(lambda: serving_ingest(P, ops, serve, dev))
    out = {"ingest": {**ingest, "phase_s": phase_s}}
    print("serving ingest: " + json.dumps(out["ingest"]), flush=True)
    for part, job in (
        ("kbstore", lambda: serving_kbstore(P, ops, serve, archives, dev)),
        ("chaos", lambda: serving_chaos(ops, serve)),
        ("fleet", lambda: serving_fleet(ops, serve, seed, dev)),
    ):
        out[part], phase_s = sync_time(job)
        out[part]["phase_s"] = phase_s
        print(f"serving {part}: " + json.dumps(out[part]), flush=True)
        torch.cuda.empty_cache()
    out["launches"] = {k: ops.launches[k] for k in SERVING_KERNELS}
    for name, n in out["launches"].items():
        check(n > 0, f"kernel {name} was not launched in the serving tier's phase")
    return out


# ---------------------------------------------------------------- phase 12
def family_batch(cfg, batch: int, length: int, seed: int, dev) -> dict:
    """Seeded inputs of a prefill of ``length``: tokens; an
    encoder-decoder's frames take ``audio_frames_ratio`` of it (the
    reference's ``input_specs`` split) and its decoder the rest; a VLM adds
    its vision embeddings [B, vision_tokens, d_model]."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if cfg.family == "encdec":
        se = int(length * cfg.audio_frames_ratio)
        frames = torch.randn((batch, se, cfg.d_model), generator=g, device=dev)
        toks = torch.randint(0, cfg.vocab_size, (batch, length - se), generator=g, device=dev)
        return {"frames": frames, "tokens": toks}
    out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, length), generator=g, device=dev)}
    if cfg.family == "vlm":
        out["vision"] = torch.randn((batch, cfg.vision_tokens, cfg.d_model), generator=g,
                                    device=dev)
    return out


def flash_layers(T, cfg) -> int:
    """Decoder layers with causal self-attention over the whole sequence
    (the flash route): kinds "attn" and "cross"; local attention, RG-LRU
    and RWKV take none, nor does an encoder."""
    n_prefix, n_groups, n_tail = T._layer_split(cfg)
    kinds = ([T._block_kind(cfg, i) for i in range(n_prefix)] + list(cfg.block_group) * n_groups
             + [T._block_kind(cfg, i) for i in range(n_tail)])
    return sum(k in ("attn", "cross") for k in kinds)


def graft(dec, pref, length: int) -> None:
    """Copy prefill caches into decode buffers in place: a cross cache whole,
    a KV or latent cache's ``length`` positions at slot = pos % buffer (a
    local ring keeps the last ones), a recurrent or RWKV state whole."""
    if isinstance(dec, dict):
        for k in dec:
            if k == "cross":
                _copy_whole(dec[k], pref[k])
            else:
                graft(dec[k], pref[k], length)
        return
    if isinstance(dec, list):
        for d, p in zip(dec, pref):
            graft(d, p, length)
        return
    if not hasattr(dec, "kpos"):  # RecState, RwkvState
        _copy_whole(dec, pref)
        return
    ax = dec.kpos.ndim - 1  # the position axis, after any group and the batch axes
    buf = dec.kpos.shape[ax]
    pos = torch.arange(max(0, length - buf), length, device=dec.kpos.device)
    for f in dataclasses.fields(dec):
        getattr(dec, f.name).index_copy_(ax, pos % buf, getattr(pref, f.name).index_select(ax, pos))


def _copy_whole(dec, pref) -> None:
    for f in dataclasses.fields(dec):
        getattr(dec, f.name).copy_(getattr(pref, f.name))


class PinnedRouting:
    """Stands in for the MoE router (``models.layers._route``): records the
    experts and probabilities of each decode step's tokens, then routes the
    same tokens of the forward pass to the experts the decode chose (gates
    from the forward's own probabilities).  Router probabilities of a
    random-init model are nearly uniform, so the decode's and the forward's
    rounding (absorbed against expanded attention) flip a near tie of the
    k-th expert; a flip moves the token's output by a whole expert.  Every
    flip must be such a near tie: the forward's k-th probability within
    twice the token's largest decode-vs-forward probability difference of
    the least of the decode's experts."""

    def __init__(self, layers_mod, batch: int, prompt: int, n_moe: int):
        self.mod, self.orig = layers_mod, layers_mod._route
        self.b, self.prompt, self.n_moe = batch, prompt, n_moe
        self.log, self.calls, self.mode = [], 0, "record"  # then "off", then "replay"
        self.flips, self.rows_flipped, self.worst_gap = 0, set(), 0.0
        layers_mod._route = self

    def __call__(self, p, xt, cfg):
        probs, gates, idx = self.orig(p, xt, cfg)
        if self.mode != "replay":
            if self.mode == "record":
                self.log.append((probs, idx))
            return probs, gates, idx
        layer = self.calls
        self.calls += 1
        seq = xt.shape[0] // self.b
        idx, gates = idx.clone(), gates.clone()
        for step in range(len(self.log) // self.n_moe):
            dec_probs, dec_idx = self.log[step * self.n_moe + layer]
            rows = torch.arange(self.b, device=xt.device) * seq + self.prompt + step
            fwd = probs[rows]
            flipped = (fwd.topk(cfg.top_k, -1).indices.sort(-1).values
                       != dec_idx.sort(-1).values).any(-1)
            if bool(flipped.any()):
                kth = fwd.topk(cfg.top_k, -1).values[:, -1]
                gap = kth - fwd.gather(1, dec_idx).amin(-1)
                slack = 2 * (fwd - dec_probs).abs().amax(-1)
                check(bool((gap[flipped] <= slack[flipped]).all()),
                      f"{cfg.name}: a decode step's experts differ from the forward's "
                      f"beyond a near tie (gap {gap[flipped].tolist()}, slack "
                      f"{slack[flipped].tolist()})")
                self.flips += int(flipped.sum())
                self.rows_flipped |= {(int(r), step) for r in torch.nonzero(flipped).flatten()}
                self.worst_gap = max(self.worst_gap, float(gap[flipped].max()))
            g = fwd.gather(1, dec_idx)
            idx[rows], gates[rows] = dec_idx, g / torch.clamp(g.sum(-1, keepdim=True), min=1e-9)
        return probs, gates, idx

    def restore(self) -> None:
        self.mod._route = self.orig


def family_decode_check(T, L, m, params, batch: dict, prompt: int, steps: int, dev) -> tuple:
    """Prefill ``prompt`` tokens, graft the caches into decode buffers of
    prompt + steps, decode greedily, and hold each step's logits to one
    forward pass over the extended prompt, whose decoded tokens an MoE
    routes to the decode's experts (``PinnedRouting``; the forward's own
    routing is compared too, and reported).  Returns (check, step times,
    the tokens fed and each step's logits, on the host, for phase 16 (f))."""
    cfg = m.cfg
    sub = dict(batch, tokens=batch["tokens"][:, :prompt])
    logits, caches = m.prefill(params, sub)
    b = logits.shape[0]
    dec = m.make_decode_caches(b, prompt + steps, device=dev)
    graft(dec, caches, prompt)
    del caches
    n_moe = sum(cfg.layer_uses_moe(i) for i in range(cfg.n_layers))
    pin = PinnedRouting(L, b, prompt, n_moe) if n_moe else None
    tok = logits[:, -1].argmax(-1, keepdim=True)
    fed, outs, step_s = [], [], []
    try:
        for i in range(steps):
            fed.append(tok)
            (out, dec), dt = sync_time(lambda: m.decode_step(params, tok, dec, prompt + i))
            step_s.append(dt)
            outs.append(out[:, 0])
            tok = out[:, -1].argmax(-1, keepdim=True)
        del dec
        ext = torch.cat([sub["tokens"]] + fed, dim=1)
        pos = torch.arange(ext.shape[1], device=dev, dtype=torch.int32)[None].expand(b, -1)
        cross = m._cross(params, batch)

        def forward():
            x, _, _ = T.apply_stack(params, T.embed_tokens(params, ext, cfg), cfg, mode="train",
                                    positions=pos, cross_source=cross)
            return T.logits_from(params, x[:, prompt:], cfg)

        got = torch.stack(outs, dim=1)
        own = None
        if pin is not None:
            pin.mode = "off"
            own = float((forward().float() - got.float()).abs().max())
            pin.mode = "replay"
        full = forward()
    finally:
        if pin is not None:
            pin.restore()
    out = logits_agree(full, got, f"{cfg.name}: decode after prefill")
    if pin is not None:
        out["routing"] = {
            "moe_layers": n_moe, "decoded_tokens": b * steps, "flips": pin.flips,
            "tokens_with_a_flip": len(pin.rows_flipped), "largest_flip_gap": pin.worst_gap,
            "max_abs_diff_own_routing": own}
    return out, step_s, [t.cpu() for t in fed], [o.cpu() for o in outs]


def check_flash_mla(FA, q, k, v_pad, v_dim: int, launches: dict) -> dict:
    """The flash kernel at MLA's shape (q and k at nope + rope, V padded with
    zeros to that width) against its plain version on layer 0's inputs, its
    time beside the plain version's and SDPA's on the unpadded V (timed
    only), and the bound on the unpadded work."""
    b, sq, h, d = q.shape
    got = FA.flash_attention_cuda(q, k, v_pad, causal=True)
    want = FA.flash_attention_plain(q, k, v_pad, causal=True)
    err = float((got.float() - want.float()).abs().max())
    check(bool(torch.allclose(got.float(), want.float(), atol=FLASH_BF16_TOL, rtol=FLASH_BF16_TOL)),
          f"flash_attention at the MLA shape differs from its plain version (max err {err})")
    check(bool((got[..., v_dim:] == 0).all()), "flash_attention: the padded V columns are not 0")
    del got, want
    ms = event_ms(lambda: FA.flash_attention_cuda(q, k, v_pad, causal=True), 10)
    plain_ms = event_ms(lambda: FA.flash_attention_plain(q, k, v_pad, causal=True), 3)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v_pad[..., :v_dim]))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = event_ms(lambda: sdpa(qt, kt, vt, is_causal=True), 10)
    pairs = b * h * sq * (sq + 1) // 2  # causal (q, k) pairs, Sk == Sq
    nops = 2 * pairs * (d + v_dim)  # q k^T at d, p v at the unpadded width
    nbytes = (q.numel() + k.numel() + 2 * b * sq * h * v_dim) * q.element_size()
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, nops / BF16_OPS_PER_S
    bound_ms = 1e3 * max(by_bytes, by_ops)
    return {
        "shape": [b, sq, h, d], "v_dim": v_dim, "launches": launches["flash_attention"],
        "max_abs_err": err, "tolerance": FLASH_BF16_TOL, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": "bytes" if by_bytes >= by_ops else "operations",
        "padded_bound_ms": 1e3 * 4 * pairs * d / BF16_OPS_PER_S,
        "library_ms": library_ms,
        "library": "torch.nn.functional.scaled_dot_product_attention(is_causal=True), V unpadded",
        "fraction_of_bound": bound_ms / ms, "vs_library": ms / library_ms,
    }


def family_path(ops, FA, T, L, build_model, cfg, seed: int, dev,
                trace: pathlib.Path | None = None) -> tuple[dict, dict | None]:
    """Phase 12, one family at full width: init, the timed prefill of
    FAMILY_BATCH x FAMILY_LEN (one flash launch a causal self-attention
    layer), the decode check; for MLA also the kernel at its shape, the CPU
    route and, under ``--trace``, a profiled prefill and four decode steps.
    Returns (stats, the MLA kernel check or None)."""
    m = build_model(cfg)
    params, init_s = sync_time(lambda: m.init(seed, device=dev))
    n_params = sum(t.numel() for t in _leaves(params))
    param_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    batch = family_batch(cfg, FAMILY_BATCH, FAMILY_LEN, seed, dev)
    want_flash = flash_layers(T, cfg)
    mla = None
    with torch.inference_mode():
        m.prefill(params, {k: v[:1, :128] for k, v in batch.items()})  # warm-up
        rec = Recorder(ops, "flash_attention") if cfg.mla else None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        try:
            (logits, caches), prefill_s = sync_time(lambda: m.prefill(params, batch))
            launches = dict(ops.launches)
        finally:
            if rec is not None:
                rec.restore()
        peak = torch.cuda.max_memory_allocated()
        del caches
        check(launches["flash_attention"] == want_flash,
              f"{cfg.name}: prefill launched flash_attention {launches['flash_attention']} "
              f"times, not once a causal self-attention layer ({want_flash})")
        check(tuple(logits.shape) == (FAMILY_BATCH, 1, cfg.padded_vocab)
              and bool(torch.isfinite(logits.float()).all()), f"{cfg.name}: prefill logits")
        if rec is not None:
            (q, k, v_pad), _ = rec.args
            mla = check_flash_mla(FA, q, k, v_pad, cfg.v_head_dim, launches)
            del q, k, v_pad, rec

        # decode after prefill; an MoE decodes at a dropless capacity
        # (capacity_factor = n_experts / top_k, so cap == tokens): capacity
        # drops make prefill and decode differ by construction
        prompt = FAMILY_DECODE_PROMPT.get(cfg.name, FAMILY_DECODE_PROMPT_DEFAULT)
        mc = m
        if cfg.n_experts:
            mc = build_model(dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k))
            for n_tok in (FAMILY_BATCH * prompt, FAMILY_BATCH * (prompt + FAMILY_DECODE)):
                cap = max(8, int(mc.cfg.capacity_factor * n_tok * cfg.top_k / cfg.n_experts))
                check(cap >= n_tok, f"{cfg.name}: the decode check's capacity {cap} drops")
        decode, step_s, fed, outs = family_decode_check(T, L, mc, params, batch, prompt,
                                                        FAMILY_DECODE, dev)

        cpu_route, profiled = None, None
        if cfg.mla and trace is not None:
            profiled = profile_model(m, params, batch["tokens"], dev, trace / cfg.name)
        if cfg.mla:
            # the CPU route: the embeddings, the head, the prefix layer and
            # the first MoE layer, on the CPU (plain versions) and the card
            sm = build_model(dataclasses.replace(cfg, n_layers=MOE_CPU_LAYERS))
            n_groups = MOE_CPU_LAYERS - len(params["prefix"])
            sub = dict(params, groups={"pos0": _first(params["groups"]["pos0"], n_groups)})
            short = batch["tokens"][:1, :MOE_CPU_LEN]
            ops.reset_launches()
            card_logits, _ = sm.prefill(sub, {"tokens": short})
            check(ops.launches["flash_attention"] == MOE_CPU_LAYERS, "CPU-route check: launches")
            sub_cpu = _tree_to(sub, "cpu")
            (cpu_logits, _), cpu_s = sync_time(lambda: sm.prefill(sub_cpu, {"tokens": short.cpu()}))
            cpu_route = logits_agree(cpu_logits, card_logits.cpu(), f"{cfg.name}: CPU route",
                                     CPU_ROUTE_TOL)
            cpu_route.update(layers=MOE_CPU_LAYERS, tokens=MOE_CPU_LEN, cpu_prefill_s=cpu_s)
            del sub_cpu, sub
        del params
    tokens = sum(t.shape[0] * t.shape[1] for name, t in batch.items() if name != "vision")
    stats = {
        "arch": cfg.name, "layers": cfg.n_layers, "enc_layers": cfg.n_enc_layers,
        "params": n_params, "param_bytes": param_bytes, "init_s": init_s,
        "batch": {k: list(v.shape) for k, v in batch.items()}, "prefill_s": prefill_s,
        "prefill_tokens_per_s": tokens / prefill_s, "max_memory_allocated_bytes": peak,
        "launches": {k: v for k, v in launches.items() if v}, "flash_launches": launches[
            "flash_attention"], "decode_prompt": prompt, "decode_steps": FAMILY_DECODE,
        "decode_step_median_s": float(np.median(step_s[1:] or step_s)),
        "decode_first_step_s": step_s[0], "decode_vs_forward": decode,
    }
    if cfg.n_experts:
        stats["decode_capacity_factor"] = mc.cfg.capacity_factor
    if cpu_route is not None:
        stats["cpu_route"] = cpu_route
    if profiled is not None:
        stats["trace"] = profiled
    # what phase 16 (f) holds its sharded steps to, bit for bit
    stats["_ref"] = {"logits": logits.cpu(), "prompt": prompt, "fed": fed, "steps": outs,
                     "capacity_factor": mc.cfg.capacity_factor}
    return stats, mla


def families_path(ops, FA, serve, get_config, seed: int, dev,
                  trace: pathlib.Path | None = None) -> tuple[dict, dict]:
    """Phase 12: every family of models slice B at full width, one at a time
    (the params freed between them), each then served by ``serve --mode
    model`` (deepseek-v2-lite-16b at the launcher's defaults, the others
    ``--reduced``).  Returns (stats by arch, the MLA kernel check)."""
    import gc

    from repro_torch.models import build_model
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    out, mla = {}, None
    for arch in FAMILIES:
        cfg = get_config(arch)
        if arch in FAMILY_LAYERS:
            cfg = dataclasses.replace(cfg, n_layers=FAMILY_LAYERS[arch])
        (stats, got), phase_s = sync_time(lambda: family_path(ops, FA, T, L, build_model, cfg,
                                                               seed, dev, trace))
        mla = mla or got
        gc.collect()
        torch.cuda.empty_cache()
        extra = () if arch == FAMILIES[0] else ("--reduced",)
        stats["serve"], serve_s = sync_time(lambda: serve_model_path(serve, arch, *extra))
        stats["serve"].update(flags=list(extra), wall_s=serve_s)
        gc.collect()
        torch.cuda.empty_cache()
        stats["phase_s"] = phase_s + serve_s
        print(f"family {arch}: " + json.dumps({k: v for k, v in stats.items() if k != "_ref"}),
              flush=True)
        out[arch] = stats
    return out, mla



# ---------------------------------------------------------------- phase 13
# training at qwen3-0.6b's full width (src/repro/configs/qwen3_0_6b.py)
TRAIN_ARCH = "qwen3-0.6b"
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 12, 2, 4096  # train_4k's length; its batch 256 cut to 2
TRAIN_CUT = 2  # layers of the cut model of (b), (d), (e) and (f)
GRAD_BATCH, GRAD_SEQ = 1, 2048  # (b)
RESUME_BATCH, RESUME_SEQ, RESUME_STEPS, RESUME_EVERY, RESUME_FAIL = 2, 512, 10, 3, 7  # (d)
COMPRESSED_STEPS = 2  # (e)
FLASH_BWD_TOL = 3e-2  # bf16: of each gradient's largest |value| (tests/test_torch_cuda.py)
GRAD_REL = 0.06  # of each leaf's largest |gradient| (tests/test_torch_train_step.py)
SHRINK_CKPT_LEAF_MAX = 1 << 16  # (f): the state's leaves the per-series codec takes here
# name -> (q shape, KV heads, V's width before its zero padding, dtype):
# the cut model's shape and MLA's on the bf16 tensor-core route, a small
# float32 case on the scalar one
BWD_SHAPES = {"train": ((2, 2048, 16, 128), 8, 128, torch.bfloat16),
              "mla": ((1, 1024, 16, 192), 16, 128, torch.bfloat16),
              "f32": ((1, 384, 4, 64), 2, 64, torch.float32)}
FLASH_BWD_F32_TOL = 1e-4  # float32 (tests/test_torch_cuda.py)
# the numbers with the scalar backward pair, before the tensor-core one
# (PERF.md sections 5 and 6; H100 80GB HBM3, 700 W): the pair at [2, 4096,
# 16/8, 128] in two runs, the cut model's worst leaf against the CPU route,
# and launch.train's median step
FLASH_BWD_PREV = {"scalar pair": {"ms": [38.37, 38.37], "graph_ms": [38.31, 38.31]}}
GRAD_CPU_REL_PREV = {"scalar pair": 0.0065}
TRAIN_STEP_PREV = {"scalar pair": {"median_step_s": [1.4387, 1.4506],
                                   "tokens_per_s": [5647.4, 5693.8]}}


def flash_bwd_case(FA, shape, kvh: int, v_dim: int, seed: int, dev, dtype=torch.bfloat16):
    """q [shape], k and v [B, S, kvh, D] (v zero-padded from v_dim), the
    forward's output and lse, and a seeded dout."""
    b, s, h, d = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(shape, device=dev, generator=g).to(dtype)
    k = torch.randn((b, s, kvh, d), device=dev, generator=g).to(dtype)
    v = torch.nn.functional.pad(torch.randn((b, s, kvh, v_dim), device=dev, generator=g),
                                (0, d - v_dim)).to(dtype)
    out, lse = FA._flash_attention_fwd_cuda(q, k, v, True)
    dout = torch.randn(shape, device=dev, generator=g).to(dtype)
    if v_dim < d:
        dout[..., v_dim:] = 0  # the model cuts the padded columns off
    return q, k, v, out, dout, lse


def check_flash_bwd(FA, seed: int, dev) -> dict:
    """(a): the backward pair against autograd through the plain version at
    the cut model's shape and MLA's (V padded) in bf16 and a small float32
    one, each with its route, then timed at the training shape beside its
    bound, its 7-product floor and SDPA's backward (timed only)."""
    errs, routes = {}, {}
    for name, (shape, kvh, v_dim, dtype) in BWD_SHAPES.items():
        q, k, v, out, dout, lse = flash_bwd_case(FA, shape, kvh, v_dim, seed, dev, dtype)
        tol = FLASH_BWD_TOL if dtype == torch.bfloat16 else FLASH_BWD_F32_TOL
        before = FA._build.launches["flash_attention_bwd"]
        got = FA.flash_attention_bwd_cuda(q, k, v, out, dout, True, lse=lse)
        check(FA._build.launches["flash_attention_bwd"] == before + 1,
              "flash_attention_bwd did not count its launch")
        routes[name] = FA.last_route["flash_attention_bwd"]
        want = FA.flash_attention_bwd_plain(q, k, v, out, dout, True)
        errs[name] = {}
        for grad, x, w in zip(("dq", "dk", "dv"), got, want):
            err = float((x.float() - w.float()).abs().max())
            scale = float(w.float().abs().max())
            errs[name][grad] = {"max_abs_err": err, "max_abs": scale}
            check(err <= tol * scale,
                  f"flash_attention_bwd {name} {grad}: max err {err} over {tol} x {scale}")
        again = FA.flash_attention_bwd_cuda(q, k, v, out, dout, True, lse=lse)
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"flash_attention_bwd {name}: two launches differ")
        print(f"flash_attention_bwd {name} {list(shape)} kv {kvh} {dtype}: route {routes[name]}, "
              + json.dumps(errs[name]), flush=True)
        del q, k, v, out, dout, lse, got, want, again
        torch.cuda.empty_cache()
    check(routes["train"] == routes["mla"] == "tensor cores" and routes["f32"] == "scalar",
          f"flash_attention_bwd routes {routes}")
    b, s, h, d = TRAIN_BATCH, TRAIN_SEQ, 16, 128
    q, k, v, out, dout, lse = flash_bwd_case(FA, (b, s, h, d), 8, d, seed + 1, dev)
    bwd = lambda: FA.flash_attention_bwd_cuda(q, k, v, out, dout, True, lse=lse)
    ms = event_ms(bwd, 5)
    route = FA.last_route["flash_attention_bwd"]
    gms = graph_ms(bwd, 3)
    plain_ms = event_ms(lambda: FA.flash_attention_bwd_plain(q, k, v, out, dout, True), 2)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
    dt = dout.transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def sdpa_fwd_bwd():
        y = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
        torch.autograd.grad(y, (qt, kt, vt), dt)

    with torch.no_grad():
        sdpa_fwd_ms = event_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True), 10)
    sdpa_ms = event_ms(sdpa_fwd_bwd, 10)
    pairs = s * (s + 1) // 2
    nops = 10 * b * h * d * pairs  # 5 products over the causal pairs, a multiply and an add
    nbytes = (3 * q.numel() + 2 * k.numel() + 2 * v.numel() + 2 * out.numel()) * 2
    row = kernel_row("flash_attention_bwd", "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                     "not a TPU kernel: the gradient of src/repro/kernels/flash_attention.py:31 "
                     "(the reference differentiates XLA ops)", {"flash_attention_bwd": 0},
                     max(e["max_abs_err"] for e in errs["train"].values()), ms, plain_ms,
                     nbytes, nops, BF16_OPS_PER_S, [b, s, h, d, 8])
    row.update(graph_ms=gms, library_ms=sdpa_ms - sdpa_fwd_ms,
               library="scaled_dot_product_attention(is_causal=True, enable_gqa=True): forward "
               "and backward less the forward", library_fwd_bwd_ms=sdpa_ms,
               library_fwd_ms=sdpa_fwd_ms, dtype="bfloat16", tolerance=FLASH_BWD_TOL,
               errors=errs, kernel_route=route, routes=routes,
               floor_7_products_ms=row["bound_ms"] * 7 / 5,
               fraction_of_bound=row["bound_ms"] / gms,
               fraction_of_7_product_floor=row["bound_ms"] * 7 / 5 / gms,
               vs_library=gms / (sdpa_ms - sdpa_fwd_ms))
    # the previous times go on this line only, never into the kernels line
    print("flash_attention_bwd: " + json.dumps({**{k: row[k] for k in (
        "kernel_route", "ms", "graph_ms", "plain_ms", "bound_ms", "floor_7_products_ms",
        "fraction_of_bound", "fraction_of_7_product_floor", "library_ms")},
        "previous": FLASH_BWD_PREV}), flush=True)
    return row


def train_batch(pipe, step: int, dev) -> dict:
    return {k: torch.from_numpy(a).to(dev) for k, a in pipe.batch_at(step).items()}


def check_model_grads(ops, FA, TS, m, params, pipe, dev) -> dict:
    """(b): the cut model's gradients on the card (the flash kernel pair),
    against the plain attention route on the card and the CPU route."""
    from repro_torch.training._tree import leaves, tree_map

    batch = train_batch(pipe, 0, dev)
    before = ops.launches["flash_attention_bwd"]
    loss, _, grads = TS._value_and_grad(m, params, batch)
    bwd_launches = ops.launches["flash_attention_bwd"] - before
    check(bwd_launches == TRAIN_CUT, f"flash_attention_bwd launched {bwd_launches} times "
          f"for {TRAIN_CUT} layers")
    flat = leaves(grads)
    check(all(g is not None and bool(torch.isfinite(g).all()) for g in flat),
          "a gradient of the cut model is missing or not finite")
    kernel_route = ops.flash_attention
    ops.flash_attention = FA.flash_attention_plain  # the plain route on the card, this call only
    try:
        _, _, plain = TS._value_and_grad(m, params, batch)
    finally:
        ops.flash_attention = kernel_route
    to_cpu = lambda t: tree_map(lambda x: x.cpu(), t)
    (_, _, cpu), cpu_s = sync_time(lambda: TS._value_and_grad(m, to_cpu(params), to_cpu(batch)))
    worst = {"plain_route": 0.0, "cpu_route": 0.0}
    for g, p, c in zip(flat, leaves(plain), leaves(cpu)):
        for name, w in (("plain_route", p), ("cpu_route", c.to(dev))):
            rel = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            worst[name] = max(worst[name], rel)
    for name, rel in worst.items():
        check(rel <= GRAD_REL, f"cut model gradients: {name} off by {rel} of a leaf's largest")
    return {"loss": float(loss), "leaves": len(flat), "bwd_launches": bwd_launches,
            "worst_rel_err": worst, "tolerance": GRAD_REL, "cpu_route_s": cpu_s,
            "previous_cpu_route_rel_err": GRAD_CPU_REL_PREV}


def train_entry_point(ops, train_mod, tmp: pathlib.Path) -> dict:
    """(c): ``launch.train`` at full width and depth, with the launch counts
    zeroed just before and read just after."""
    argv = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--batch", str(TRAIN_BATCH),
            "--seq", str(TRAIN_SEQ), "--ckpt-every", "100", "--ckpt-dir", str(tmp / "ck")]
    out, err = io.StringIO(), io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc, wall = sync_time(lambda: train_mod.main(argv))
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated()
    print(out.getvalue().strip() + "\n" + err.getvalue().strip(), flush=True)
    check(rc == 0, f"launch.train {' '.join(argv)} exited {rc}")
    losses = [float(x) for x in re.findall(r"^step +\d+  loss (\S+)", out.getvalue(), re.M)]
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
          f"launch.train: losses {losses}")
    check(np.mean(losses[-4:]) < np.mean(losses[:4]), f"launch.train: loss did not fall {losses}")
    med = re.search(r"median step ([\d.]+) s, ([\d.]+) tokens/s", err.getvalue())
    check(med is not None, "launch.train printed no step time")
    times = re.search(r"step times s ([\d. ]+)$", err.getvalue(), re.M)
    for name in ("flash_attention", "flash_attention_bwd"):
        check(launches[name] > 0, f"kernel {name} was not launched by launch.train")
    return {"argv": argv, "wall_s": wall, "losses": losses, "median_step_s": float(med.group(1)),
            "tokens_per_s": float(med.group(2)), "peak_memory_gb": peak / 1e9,
            "step_times_s": [float(t) for t in times.group(1).split()] if times else None,
            "launches": {k: v for k, v in launches.items() if v},
            "launches_a_step": {k: launches[k] / TRAIN_STEPS
                                for k in ("flash_attention", "flash_attention_bwd")},
            "cut": {"batch": "256 -> 2 (one card)"}, "previous": TRAIN_STEP_PREV}


def crash_resume(TS, FT, opt_mod, m, params, pipe, tmp: pathlib.Path, dev) -> tuple[dict, dict]:
    """(d): an uninterrupted run against a crash at RESUME_FAIL and a resume
    from the last checkpoint: the params equal leaf by leaf."""
    from repro_torch.training._tree import leaves

    step_fn = TS.make_train_step(m, None, opt_mod.AdamWConfig(lr=1e-3, warmup_steps=2,
                                                             decay_steps=RESUME_STEPS))

    def runner_step(state, batch):
        p, o, metrics = step_fn(state["params"], state["opt"], batch)
        return {"params": p, "opt": o}, metrics

    init = {"params": params, "opt": opt_mod.adamw_init(params)}
    data = lambda step: train_batch(pipe, step, dev)
    r1 = FT.TrainingRunner(runner_step, data, init, str(tmp / "a"), ckpt_every=RESUME_EVERY)
    hist = r1.run(RESUME_STEPS)
    r2 = FT.TrainingRunner(runner_step, data, init, str(tmp / "b"), ckpt_every=RESUME_EVERY,
                           fail_at=RESUME_FAIL)
    try:
        r2.run(RESUME_STEPS)
        fail("the crash at step RESUME_FAIL did not happen")
    except RuntimeError as e:
        check("simulated node failure" in str(e), f"unexpected failure {e}")
    r3 = FT.TrainingRunner(runner_step, data, init, str(tmp / "b"), ckpt_every=RESUME_EVERY)
    resumed_from = r3.start_step
    hist3 = r3.run(RESUME_STEPS)
    same = [torch.equal(a, b) for a, b in zip(leaves(r1.state["params"]),
                                             leaves(r3.state["params"]))]
    check(all(same), f"crash and resume: {same.count(False)} param leaves differ")
    check(hist3 == hist[resumed_from:], "crash and resume: the resumed losses differ")
    return {"steps": RESUME_STEPS, "fail_at": RESUME_FAIL, "resumed_from": resumed_from,
            "param_leaves_equal": len(same), "losses": [h["loss"] for h in hist]}, r1


def compressed_steps(ops, BF, GC, TS, PP, opt_mod, m, params, pipe, dev) -> dict:
    """(e): ``make_compressed_train_step`` on a one-rank NCCL DeviceMesh with
    a "pod" dimension (the params whole); base_fit against its plain version
    on the step's own blocks, the exchange against the CPU route's; then
    the same steps on a one-rank ("pod", "data", "model") mesh from params
    placed by ``param_shardings`` (each rank's ``param_specs`` shards, the
    exchange on whole blocks of each leaf), every state leaf, error feedback
    and loss bit-equal to the whole-params run."""
    import socket

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.parallel.sharding import place
    from repro_torch.training._tree import leaves, tree_map

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    comp_cfg = GC.GradCompressConfig()

    def run(mesh, p, record: bool):
        step = TS.make_compressed_train_step(m, mesh, opt_mod.AdamWConfig(lr=1e-3), comp_cfg)
        opt, ef, losses = opt_mod.adamw_init(p), TS.make_ef_state(p), []
        for s in range(COMPRESSED_STEPS):
            if record and s == 0:
                recorders = Recorder(ops, "base_fit"), Recorder(TS, "compressed_psum_shards")
            p, opt, ef, metrics = step(p, opt, ef, train_batch(pipe, s, dev))
            if record and s == 0:
                for r in recorders:
                    r.restore()
            losses.append(float(metrics["loss"]))
        return (p, opt, ef), losses, (recorders if record else None)

    try:
        before = ops.launches["base_fit"]
        whole_state, losses, (fit, exchange) = run(
            init_device_mesh("cuda", (1,), mesh_dim_names=("pod",)), params, True)
        fit_launches = ops.launches["base_fit"] - before
        mesh = init_device_mesh("cuda", (1, 1, 1), mesh_dim_names=("pod", "data", "model"))
        placed = tree_map(lambda p, s: place(p, *s), params,
                          PP.param_shardings(params, m.cfg, mesh))
        before = ops.launches["base_fit"]
        (sharded_state, sharded_losses, _), sharded_s = sync_time(lambda: run(mesh, placed, False))
        sharded_fit = ops.launches["base_fit"] - before
        equal = sum(torch.equal(local(a), local(b)) for a, b in zip(leaves(sharded_state),
                                                             leaves(whole_state), strict=True))
        n_state = len(leaves(whole_state))
        del sharded_state, placed
    finally:
        dist.destroy_process_group()
    check(fit_launches > 0 and sharded_fit > 0, "base_fit was not launched by the compressed step")
    check(all(np.isfinite(losses)), f"compressed step losses {losses}")
    check(equal == n_state and sharded_losses == losses,
          f"compressed step on a (1, 1, 1) mesh: {n_state - equal} of {n_state} state leaves "
          f"differ from the whole-params run, losses {sharded_losses} vs {losses}")
    (xb,), _ = fit.args
    got, want = BF.base_fit_cuda(xb), BF.base_fit_plain(xb)
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          "base_fit differs from its plain version on the compressed step's blocks")
    (grads, ef0, _, _, cfg, _), _ = exchange.args
    card, card_ef = GC.compressed_psum_tree(grads, ef0, cfg)
    to_cpu = lambda t: tree_map(lambda x: x.cpu(), t)
    (cpu, cpu_ef), cpu_s = sync_time(lambda: GC.compressed_psum_tree(to_cpu(grads),
                                                                     to_cpu(ef0), cfg))
    differ = sum(int((a.cpu() != b).sum()) for a, b in zip(leaves(card) + leaves(card_ef),
                                                          leaves(cpu) + leaves(cpu_ef)))
    total = sum(a.numel() for a in leaves(card) + leaves(card_ef))
    comp, raw = GC.compression_wire_bytes(params, comp_cfg)
    return {"steps": COMPRESSED_STEPS, "losses": losses, "base_fit_launches": fit_launches,
            "base_fit_blocks": list(xb.shape), "elements_differing_from_cpu_route": differ,
            "elements": total, "cpu_route_s": cpu_s, "wire_bytes": comp, "raw_bytes": raw,
            "ratio": raw / comp,
            "sharded_mesh": {"pod": 1, "data": 1, "model": 1},
            "sharded_state_leaves_equal": equal, "sharded_losses_equal": True,
            "sharded_base_fit_launches": sharded_fit, "sharded_s": sharded_s}


def codec_in_training(ops, CK, ML, state, losses: dict, tmp: pathlib.Path, dev) -> dict:
    """(f): a shrink:1e-3 checkpoint of (d)'s small leaves on the card and
    on the CPU route (SHRK leaf files equal), read back on the card; a
    MetricsLogger flush of (c)'s and (d)'s losses and its lossless read."""
    from repro_torch.training._tree import leaves

    before = dict(ops.launches)
    small = {f"leaf{i:03d}": x for i, x in enumerate(leaves(state))
             if x.numel() <= SHRINK_CKPT_LEAF_MAX}
    CK.save_checkpoint(tmp / "card", 0, small, codec="shrink:1e-3")
    CK.save_checkpoint(tmp / "cpu", 0, {k: x.cpu() for k, x in small.items()},
                       codec="shrink:1e-3")
    metas = json.loads((tmp / "card" / "step_0" / "manifest.json").read_text())["leaves"]
    shrunk = [i for i, meta in enumerate(metas) if meta["codec"] == "shrink:1e-3"]
    check(len(shrunk) >= 2, f"only {len(shrunk)} leaves went through SHRINK")
    for i in shrunk:
        check((tmp / "card" / "step_0" / f"leaf_{i}.bin").read_bytes()
              == (tmp / "cpu" / "step_0" / f"leaf_{i}.bin").read_bytes(),
              f"shrink checkpoint leaf {i}: card bytes differ from the CPU route's")
    back, _ = CK.load_checkpoint(tmp / "card", small)
    for meta, a, b in zip(metas, leaves(back), leaves(small)):
        # within eps, plus the float32 rounding of the decoded value
        err = float((a.double() - b.double()).abs().max())
        bound = meta.get("eps", 0.0) + float(torch.finfo(torch.float32).eps * b.abs().max())
        check(err <= bound, f"shrink checkpoint: a leaf read back {err} off (bound {bound})")
    log = ML.MetricsLogger(tmp / "metrics", device=dev)
    for name, vals in losses.items():
        for i, v in enumerate(vals):
            log.log(i, {name: v})
    sizes = log.flush()
    for name, vals in losses.items():
        want = np.round(np.asarray(vals, dtype=np.float64), log.decimals)
        check(np.array_equal(log.read(name), want), f"MetricsLogger {name}: not lossless")
    launches = {k: ops.launches[k] - before[k] for k in ("cone_scan", "rans_encode",
                                                         "rans_decode")}
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched by the codec in training")
    return {"shrink_leaves": len(shrunk), "leaves": len(metas),
            "leaf_max_elements": SHRINK_CKPT_LEAF_MAX, "metrics_bytes": sizes,
            "launches": launches}


def profile_train_step(TS, opt_mod, build_model, cfg, seed: int, dev,
                       out_dir: pathlib.Path) -> dict:
    """Phase 13 under ``--trace``: one train step of the full model at (c)'s
    batch, after a warm-up step, under torch.profiler: device busy share and
    the device time by kernel (a Chrome trace in ``out_dir``)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.pipeline import TokenPipeline

    m = build_model(cfg)
    params = m.init(seed, device=dev)
    opt = opt_mod.adamw_init(params)
    step = TS.make_train_step(m, None, opt_mod.AdamWConfig())
    batch = train_batch(TokenPipeline(vocab_size=cfg.vocab_size, batch=TRAIN_BATCH,
                                      seq_len=TRAIN_SEQ), 0, dev)
    params, opt, _ = step(params, opt, batch)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall0 = time.perf_counter()
        step(params, opt, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - wall0
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "train_step_trace.json"
    prof.export_chrome_trace(str(path))
    busy_ms, ops_ms = device_busy(path)
    res = {"wall_s": wall, "device_busy_ms": busy_ms, "device_busy_share": busy_ms / 1e3 / wall,
           "device_events": sum(r["calls"] for r in ops_ms.values()),
           "top_device_ops": dict(sorted(ops_ms.items(), key=lambda kv: -kv[1]["device_ms"])[:12])}
    (out_dir / "train_step_trace_summary.json").write_text(json.dumps(res, indent=1))
    return res


def training_path(ops, FA, BF, seed: int, dev,
                  trace: pathlib.Path | None = None) -> tuple[dict, dict]:
    """Phase 13: training at qwen3-0.6b's full width, (a)-(f) (and, under
    ``--trace``, a profiled step of the full model).  Returns the stats and
    the flash_attention_bwd kernel row."""
    import gc
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import train as train_mod
    from repro_torch.models import build_model
    from repro_torch.parallel import partition as PP
    from repro_torch.training import checkpoint as CK
    from repro_torch.training import fault_tolerance as FT
    from repro_torch.training import grad_compress as GC
    from repro_torch.training import metrics as ML
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import train_step as TS

    stats = {}
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        t0 = time.perf_counter()
        row = check_flash_bwd(FA, seed, dev)
        stats["a_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_CUT)
        m = build_model(cfg)
        params = m.init(seed, device=dev)
        pipe = TokenPipeline(vocab_size=cfg.vocab_size, batch=GRAD_BATCH, seq_len=GRAD_SEQ)
        (stats["grads"], stats["b_s"]) = sync_time(lambda: check_model_grads(
            ops, FA, TS, m, params, pipe, dev))
        print("train grads: " + json.dumps(stats["grads"]), flush=True)
        print(f"train grads: worst leaf against the CPU route "
              f"{stats['grads']['worst_rel_err']['cpu_route']:.4%} (scalar pair: "
              f"{GRAD_CPU_REL_PREV['scalar pair']:.2%}; bound {GRAD_REL:.0%})", flush=True)
        gc.collect()
        torch.cuda.empty_cache()

        (stats["entry_point"], stats["c_s"]) = sync_time(lambda: train_entry_point(
            ops, train_mod, tmp))
        row["launches"] = stats["entry_point"]["launches"].get("flash_attention_bwd", 0)
        row["launches_a_step"] = stats["entry_point"]["launches_a_step"]["flash_attention_bwd"]
        shutil.rmtree(tmp / "ck", ignore_errors=True)
        print("train entry point: " + json.dumps(stats["entry_point"]), flush=True)
        ep, prev = stats["entry_point"], TRAIN_STEP_PREV["scalar pair"]
        print(f"train entry point: median step {ep['median_step_s']} s, {ep['tokens_per_s']} "
              f"tokens/s (scalar pair: {prev['median_step_s'][0]}-{prev['median_step_s'][1]} s, "
              f"{prev['tokens_per_s'][0]}-{prev['tokens_per_s'][1]} tokens/s)", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        if trace is not None:
            stats["trace"] = profile_train_step(TS, opt_mod, build_model,
                                                get_config(TRAIN_ARCH), seed, dev, trace)
            print("train step trace: " + json.dumps(stats["trace"]), flush=True)
            gc.collect()
            torch.cuda.empty_cache()

        pipe = TokenPipeline(vocab_size=cfg.vocab_size, batch=RESUME_BATCH, seq_len=RESUME_SEQ)
        ((stats["crash_resume"], r1), stats["d_s"]) = sync_time(lambda: crash_resume(
            TS, FT, opt_mod, m, params, pipe, tmp, dev))
        print("train crash and resume: " + json.dumps(stats["crash_resume"]), flush=True)

        (stats["compressed"], stats["e_s"]) = sync_time(lambda: compressed_steps(
            ops, BF, GC, TS, PP, opt_mod, m, params, pipe, dev))
        print("train compressed step: " + json.dumps(stats["compressed"]), flush=True)
        gc.collect()
        torch.cuda.empty_cache()

        losses = {"train_loss": stats["entry_point"]["losses"],
                  "resume_loss": stats["crash_resume"]["losses"]}
        (stats["codec"], stats["f_s"]) = sync_time(lambda: codec_in_training(
            ops, CK, ML, r1.state, losses, tmp, dev))
        print("train codec: " + json.dumps(stats["codec"]), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return stats, row

# ---------------------------------------------------------------- phase 14
# the parallel layer on a DeviceMesh: one card, so one-rank NCCL meshes on
# the card and the multi-rank part on gloo processes on the CPU
PAR_ARCH, EP_ARCH = "qwen3-0.6b", "deepseek-v2-lite-16b"
PAR_STEPS = 3  # (a), at phase 13's TRAIN_BATCH x TRAIN_SEQ
EP_BATCH, EP_LEN = 4, 2048  # (b), phase 12's prefill
EP_RANKS, EP_TOKENS, EP_THREADS = 4, 2048, 2  # (c): 4 gloo ranks of 2 cores each
EP_TOL = (0.02, 0.02)  # atol, rtol (tests/test_torch_moe_ep.py, the reference's test)
EXCHANGE_REL = 0.05  # (d): of each leaf's largest |gradient| (tests/test_sharding.py)
EP_TIMEOUT = 300  # seconds for (c)'s ranks
EP_WORKER = r"""
import json, sys, time
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
d, rank, world, arch, tokens, threads = sys.argv[1:7]
rank, world, tokens = int(rank), int(world), int(tokens)
torch.set_num_threads(int(threads))
dist.init_process_group("gloo", init_method=f"file://{d}/rendezvous", rank=rank,
                        world_size=world)
try:
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.parallel.sharding import axis_rules, make_rules
    cfg = dataclasses.replace(get_config(arch), moe_ep=True)
    gen = torch.Generator().manual_seed(0)
    p = L.moe_init(gen, cfg)
    x = torch.randn((1, tokens, cfg.d_model), generator=gen).to(L.COMPUTE_DTYPE)
    mesh = init_device_mesh("cpu", (1, world), mesh_dim_names=("data", "model"))
    count = cfg.n_experts // world
    local = {k: (v[rank * count:(rank + 1) * count].clone() if k in ("wg", "wu", "wd") else v)
             for k, v in p.items()}
    with torch.inference_mode(), axis_rules(make_rules(mesh, cfg)):
        t0 = time.perf_counter()
        y, aux = L.moe_apply(local, x, cfg)
        ep_s = time.perf_counter() - t0
    out = {"rank": rank, "ep_s": ep_s,
           "expert_bytes": sum(local[k].numel() * local[k].element_size()
                               for k in ("wg", "wu", "wd"))}
    if rank == 0:
        with torch.inference_mode():
            t0 = time.perf_counter()
            y_d, aux_d = L.moe_apply(p, x, dataclasses.replace(cfg, moe_ep=False))
            dense_s = time.perf_counter() - t0
        diff = (y.float() - y_d.float()).abs()
        out.update(max_abs_diff=float(diff.max()), aux=float(aux), aux_diff=float(
            (aux - aux_d).abs()), dense_s=dense_s,
            within=bool(torch.allclose(y.float(), y_d.float(), atol=float(sys.argv[7]),
                                       rtol=float(sys.argv[8]))),
            finite=bool(torch.isfinite(y.float()).all()))
    print("EP " + json.dumps(out), flush=True)
finally:
    dist.destroy_process_group()
"""


def one_rank_group(dev):
    """A one-rank process group for the card's meshes (gloo on the CPU)."""
    import socket

    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    if dev.type == "cuda":
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                                world_size=1,
                                device_id=torch.device("cuda", torch.cuda.current_device()))
    else:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=0,
                                world_size=1)


def local(t):
    """A DTensor's local tensor (on a one-rank mesh, the whole leaf)."""
    return t.to_local() if hasattr(t, "to_local") else t


def dp_steps(ops, TS, opt_mod, m, params, pipe, mesh, dev) -> tuple[dict, dict, dict]:
    """(a): PAR_STEPS steps on ``mesh`` (launches counted) from plain params,
    which every rank holds whole, against the one-device step from the same
    params, each run after one warm-up step whose result is dropped
    (NCCL's communicator, the allocator's first blocks); returns the stats, the mesh run's state (DTensors) and the
    one-device run's state (on the host), losses, grad norms and times."""
    from repro_torch.training._tree import leaves

    batches = [train_batch(pipe, s, dev) for s in range(PAR_STEPS)]
    runs, launches = {}, {}
    for name, mesh_arg in (("mesh", mesh), ("one_device", None)):
        step = TS.make_train_step(m, mesh_arg, opt_mod.AdamWConfig())
        state = (params, opt_mod.adamw_init(params))
        sync_time(lambda: step(*state, batches[0]))  # warm-up, discarded
        times, losses, grad_norms = [], [], []
        if name == "mesh":
            ops.reset_launches()
        for b in batches:
            (p, o, metrics), s = sync_time(lambda: step(*state, b))
            state = (p, o)
            times.append(s)
            losses.append(float(metrics["loss"]))
            grad_norms.append(float(metrics["grad_norm"]))
        if name == "mesh":
            launches = dict(ops.launches)
        runs[name] = (state, times, losses)
    (got, t_mesh, l_mesh), (want, t_one, l_one) = runs["mesh"], runs["one_device"]
    pairs = list(zip(leaves(got), leaves(want)))
    equal = sum(torch.equal(local(a), b) for a, b in pairs)
    check(equal == len(pairs), f"(a) data-parallel step: {len(pairs) - equal} of {len(pairs)} "
          "state leaves differ from the one-device step's")
    check(l_mesh == l_one and all(np.isfinite(l_mesh)), f"(a) losses {l_mesh} vs {l_one}")
    for name in ("flash_attention", "flash_attention_bwd"):
        check(launches[name] > 0, f"(a) the data-parallel step launched no {name}")
    stats = {"steps": PAR_STEPS, "batch": [TRAIN_BATCH, TRAIN_SEQ], "mesh": {"data": 1, "model": 1},
             "state_leaves_equal": equal, "state_leaves": len(pairs), "losses": l_mesh,
             "median_step_s": {"mesh": float(np.median(t_mesh)),
                               "one_device": float(np.median(t_one))},
             "step_times_s": {"mesh": t_mesh, "one_device": t_one},
             "launches": {k: v for k, v in launches.items() if v}}
    # phase 16 (a) holds the sharded step from placed params to this run
    one = {"state": [t.cpu() for t in leaves(want)], "losses": l_one, "step_s": t_one,
           "grad_norms": grad_norms}
    return stats, {"params": got[0], "opt": got[1]}, one


def mesh_checkpoint(CK, PP, TS, opt_mod, m, state, pipe, tmp: pathlib.Path, dev) -> dict:
    """(e): (a)'s state saved, then restored through ``param_shardings``
    onto a new ("pod", "data", "model") mesh: every leaf equal; one
    sharded step on that mesh from the restored state equal to the
    one-device step from (a)'s, leaf for leaf."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.training._tree import leaves

    (_, save_s) = sync_time(lambda: CK.save_checkpoint(tmp / "par", PAR_STEPS - 1, state,
                                                       codec="none"))
    mesh = init_device_mesh(dev.type, (1, 1, 1), mesh_dim_names=("pod", "data", "model"))
    ps = PP.param_shardings(state["params"], m.cfg, mesh)
    shardings = {"params": ps, "opt": {"m": ps, "v": ps, "step": None}}
    (got, step), load_s = sync_time(lambda: CK.load_checkpoint(tmp / "par", state,
                                                               shardings=shardings))
    pairs = list(zip(leaves(got), leaves(state)))
    on_mesh = sum(hasattr(a, "device_mesh") for a, _ in pairs)
    equal = sum(torch.equal(local(a), local(b)) for a, b in pairs)
    check(step == PAR_STEPS - 1 and equal == len(pairs) and on_mesh == 3 * len(leaves(
        state["params"])), f"(e) mesh checkpoint: {equal} of {len(pairs)} leaves equal, "
          f"{on_mesh} on the mesh")
    batch, opt_cfg = train_batch(pipe, PAR_STEPS, dev), opt_mod.AdamWConfig()
    resumed, resume_s = sync_time(lambda: TS.make_train_step(m, mesh, opt_cfg)(
        got["params"], got["opt"], batch))
    del got
    from repro_torch.training._tree import tree_map

    plain_state = tree_map(local, state)
    plain = TS.make_train_step(m, None, opt_cfg)(plain_state["params"], plain_state["opt"], batch)
    step_pairs = list(zip(leaves(resumed), leaves(plain)))
    step_equal = sum(torch.equal(local(a), b) for a, b in step_pairs)
    check(step_equal == len(step_pairs), f"(e) the step resumed on the mesh: "
          f"{len(step_pairs) - step_equal} of {len(step_pairs)} leaves and metrics differ from "
          f"the one-device step's")
    nbytes = sum(f.stat().st_size for f in (tmp / "par").rglob("leaf_*.bin"))
    return {"step": step, "leaves": len(pairs), "leaves_on_mesh": on_mesh, "leaves_equal": equal,
            "bytes": nbytes, "save_s": save_s, "load_s": load_s,
            "mesh": {"pod": 1, "data": 1, "model": 1},
            "resumed_step": {"leaves_equal": step_equal, "leaves": len(step_pairs),
                             "loss": float(resumed[2]["loss"]), "step_s": resume_s}}


def crosspod_exchange(ops, GC, PP, cfg, params, dev) -> tuple[dict, int]:
    """(d): the exchange stage at the model's leaves on a one-rank (pod,
    data, model) mesh, plain and compressed, a leaf at a time and flat:
    the wire bytes against float32 and the worst error of one pod's mean
    against its gradient.  Returns the stats and the base_fit launches."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.training._tree import leaves, tree_map

    mesh = init_device_mesh(dev.type, (1, 1, 1), mesh_dim_names=("pod", "data", "model"))
    specs = PP.param_specs(params, cfg, mesh)
    gen = torch.Generator(device=dev).manual_seed(7)
    grads = tree_map(lambda p: torch.randn(p.shape, generator=gen, device=dev) * 1e-3, params)
    stacked = tree_map(lambda g: g[None], grads)
    ef = tree_map(torch.zeros_like, grads)
    comp = GC.GradCompressConfig()
    out, fit_launches = {}, 0
    for name, cc, flat in (("plain", None, False), ("plain_flat", None, True),
                           ("compressed", comp, False), ("compressed_flat", comp, True)):
        fn = GC.make_crosspod_exchange(mesh, cc, specs, flat=flat)
        ops.reset_launches()
        (mean, new_ef), wall = sync_time(lambda: fn(stacked, ef))
        launched = ops.launches["base_fit"]
        fit_launches += launched
        worst = max(float((a.to_local() - g).abs().max()) / float(g.abs().max())
                    for a, g in zip(leaves(mean), leaves(grads)))
        if cc is None:
            check(worst == 0.0, f"(d) {name}: one pod's plain mean differs from its gradient")
        else:
            check(launched > 0, f"(d) {name}: base_fit was not launched")
            check(worst <= EXCHANGE_REL, f"(d) {name}: off by {worst} of a leaf's largest")
        out[name] = {"wall_s": wall, "base_fit_launches": launched, "worst_rel_err": worst}
        del mean, new_ef
    wire, raw = GC.compression_wire_bytes(params, comp)
    out.update(leaves=len(leaves(params)), elements=sum(p.numel() for p in leaves(params)),
               wire_bytes=wire, raw_bytes=raw, ratio=raw / wire, tolerance=EXCHANGE_REL)
    return out, fit_launches


def ep_prefill(ops, L, TS, get_config, build_model, mesh, seed: int, dev) -> tuple[dict, int]:
    """(b): deepseek-v2-lite-16b at full width and depth, prefill of
    EP_BATCH x EP_LEN with ``moe_ep`` under the mesh's rules (every MoE
    layer through the expert-parallel route; launches counted) against the
    dense path.  Returns the stats and the flash launches."""
    cfg = get_config(EP_ARCH)
    m_ep = build_model(dataclasses.replace(cfg, moe_ep=True))
    params = m_ep.init(seed, device=dev)
    batch = family_batch(cfg, EP_BATCH, EP_LEN, seed, dev)
    ep_calls = []
    orig = L._moe_apply_ep
    L._moe_apply_ep = lambda *a: ep_calls.append(1) or orig(*a)
    try:
        with torch.inference_mode():
            prefill = TS.make_prefill_step(m_ep, mesh)
            prefill(params, {k: v[:1, :128] for k, v in batch.items()})  # warm-up
            ep_calls.clear()
            ops.reset_launches()
            (logits, _), ep_s = sync_time(lambda: prefill(params, batch))
            launches = dict(ops.launches)
            logits = logits.to_local()  # this rank's rows of the global batch: all of them
            dense = TS.make_prefill_step(build_model(cfg), None)
            (want, _), dense_s = sync_time(lambda: dense(params, batch))
    finally:
        L._moe_apply_ep = orig
    moe_layers = cfg.n_layers - cfg.first_dense_layers
    diff = float((logits.float() - want.float()).abs().max())
    close = bool(torch.allclose(logits.float(), want.float(), atol=EP_TOL[0], rtol=EP_TOL[1]))
    check(len(ep_calls) == moe_layers, f"(b) {len(ep_calls)} expert-parallel MoE calls, not "
          f"one a MoE layer ({moe_layers})")
    check(launches["flash_attention"] == cfg.n_layers, f"(b) flash_attention launched "
          f"{launches['flash_attention']} times for {cfg.n_layers} layers")
    check(close and bool(torch.isfinite(logits.float()).all()),
          f"(b) EP prefill logits off the dense path's by {diff}")
    agree = float((logits.float().argmax(-1) == want.float().argmax(-1)).float().mean())
    del params
    return {"batch": [EP_BATCH, EP_LEN], "ep_layers": len(ep_calls), "prefill_s": ep_s,
            "dense_prefill_s": dense_s, "bits_equal_to_dense": bool(torch.equal(logits, want)),
            "max_abs_diff": diff, "top1_agreement": agree, "tolerance": list(EP_TOL),
            "launches": {k: v for k, v in launches.items() if v}}, launches["flash_attention"]


def ep_gloo_ranks(tmp: pathlib.Path) -> dict:
    """(c): one MoE layer of deepseek-v2-lite-16b at full expert width (64
    experts of 2048 x 1408, top-6, two shared) on EP_RANKS gloo processes
    on the CPU, 16 experts a rank, EP_TOKENS tokens, against the dense
    ``moe_apply`` on rank 0."""
    import os

    run = tmp / "ep"
    run.mkdir()
    env = dict(os.environ, PYTHONPATH=str(SRC))
    args = [EP_RANKS, EP_ARCH, EP_TOKENS, EP_THREADS, *EP_TOL]
    procs = [subprocess.Popen([sys.executable, "-c", EP_WORKER, str(run), str(r)]
                              + [str(a) for a in args], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(EP_RANKS)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=EP_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    check(all(p.returncode == 0 for p in procs), "(c) an EP rank failed:\n" + "\n".join(logs))
    outs = [json.loads(line[3:]) for log in logs for line in log.splitlines()
            if line.startswith("EP ")]
    first = next(o for o in outs if o["rank"] == 0)
    check(first["within"] and first["finite"], f"(c) EP on {EP_RANKS} ranks off the dense path "
          f"by {first['max_abs_diff']} (tolerance {EP_TOL})")
    return {"ranks": EP_RANKS, "tokens": EP_TOKENS, "threads_a_rank": EP_THREADS,
            "max_abs_diff": first["max_abs_diff"], "aux": first["aux"],
            "aux_diff": first["aux_diff"], "tolerance": list(EP_TOL),
            "expert_bytes_a_rank": first["expert_bytes"], "dense_s": first["dense_s"],
            "ep_s": [o["ep_s"] for o in sorted(outs, key=lambda o: o["rank"])]}


def dots_remat(TS, opt_mod, build_model, cfg, params, pipe, dev) -> dict:
    """(f): one train step with ``remat_policy="dots"`` and one with
    ``"nothing"`` from the same state: every leaf equal; the peak memory of
    each."""
    from repro_torch.training._tree import leaves

    batch = train_batch(pipe, 0, dev)
    out, states = {}, {}
    for policy in ("nothing", "dots"):
        m = build_model(dataclasses.replace(cfg, remat=True, remat_policy=policy))
        step = TS.make_train_step(m, None, opt_mod.AdamWConfig())
        opt = opt_mod.adamw_init(params)
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        (p, o, _), wall = sync_time(lambda: step(params, opt, batch))
        peak = torch.cuda.max_memory_allocated()
        states[policy] = (p, o)
        out[policy] = {"wall_s": wall, "peak_memory_gb": peak / 1e9,
                       "peak_above_start_gb": (peak - start) / 1e9}
        del opt
    pairs = list(zip(leaves(states["dots"]), leaves(states["nothing"])))
    equal = sum(torch.equal(a, b) for a, b in pairs)
    check(equal == len(pairs), f"(f) dots: {len(pairs) - equal} of {len(pairs)} leaves differ "
          "from nothing's")
    out.update(leaves_equal=equal, leaves=len(pairs), batch=[TRAIN_BATCH, TRAIN_SEQ],
               layers=cfg.n_layers)
    return out


def parallel_path(ops, get_config, seed: int, dev) -> tuple[dict, dict, dict]:
    """Phase 14: (a)-(f).  Returns the stats, the phase's launches of its
    path's kernels ((a)'s mesh steps, (b)'s EP prefill, (d)'s exchanges),
    each counted from 0 just before and read just after, and (a)'s
    one-device run (for phase 16)."""
    import gc
    import shutil
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import build_model
    from repro_torch.models import layers as L
    from repro_torch.parallel import partition as PP
    from repro_torch.training import checkpoint as CK
    from repro_torch.training import grad_compress as GC
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import train_step as TS

    stats, tmp = {}, pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_parallel_"))
    one_rank_group(dev)
    try:
        mesh = init_device_mesh(dev.type, (1, 1), mesh_dim_names=("data", "model"))
        cfg = get_config(PAR_ARCH)
        m = build_model(cfg)
        params = m.init(seed, device=dev)
        pipe = TokenPipeline(vocab_size=cfg.vocab_size, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ)
        (stats["a"], state, one), a_s = sync_time(lambda: dp_steps(ops, TS, opt_mod, m, params,
                                                                     pipe, mesh, dev))
        stats["a"]["phase_s"] = a_s
        print("parallel (a) data-parallel step: " + json.dumps(stats["a"]), flush=True)
        stats["e"], e_s = sync_time(lambda: mesh_checkpoint(CK, PP, TS, opt_mod, m, state, pipe,
                                                            tmp, dev))
        stats["e"]["phase_s"] = e_s
        print("parallel (e) mesh checkpoint: " + json.dumps(stats["e"]), flush=True)
        del state
        shutil.rmtree(tmp / "par", ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
        (stats["d"], fit_launches), d_s = sync_time(lambda: crosspod_exchange(
            ops, GC, PP, cfg, params, dev))
        stats["d"]["phase_s"] = d_s
        print("parallel (d) cross-pod exchange: " + json.dumps(stats["d"]), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        stats["f"], f_s = sync_time(lambda: dots_remat(TS, opt_mod, build_model, cfg, params,
                                                       pipe, dev))
        stats["f"]["phase_s"] = f_s
        print("parallel (f) dots remat: " + json.dumps(stats["f"]), flush=True)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        (stats["b"], ep_flash), b_s = sync_time(lambda: ep_prefill(
            ops, L, TS, get_config, build_model, mesh, seed, dev))
        stats["b"]["phase_s"] = b_s
        print("parallel (b) EP prefill: " + json.dumps(stats["b"]), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    stats["c"], c_s = sync_time(lambda: ep_gloo_ranks(tmp))
    stats["c"]["phase_s"] = c_s
    print(f"parallel (c) expert parallelism on {EP_RANKS} gloo ranks: " + json.dumps(stats["c"]),
          flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    launches = {"flash_attention": stats["a"]["launches"]["flash_attention"] + ep_flash,
                "flash_attention_bwd": stats["a"]["launches"]["flash_attention_bwd"],
                "base_fit": fit_launches}
    one["median_step_s"] = stats["a"]["median_step_s"]
    return stats, launches, one


# ---------------------------------------------------------------- phase 15
# (b): two steps counted on the card and on meta; (c): the paper's
# baselines on the gateway's rows; (a): the dry-run sweeps on the host's
# CPU, started after (c), so no phase timed on the card shares the host with
# them; phase 16's gloo ranks (its (c)) run beside them, and each reports
# its own wall
DRYRUN_SWEEPS = {
    "single-pod": ["--all"],
    "multi-pod": ["--all", "--multi-pod"],
    "compressed": ["--arch", "qwen3-0.6b", "--shape", "train_4k", "--multi-pod", "--compressed"],
}
DRYRUN_TIMEOUT = 300  # seconds from its start a sweep may take
COUNT_CELLS = (("qwen3-0.6b", "train", TRAIN_BATCH, TRAIN_SEQ),  # phase 13's cut
               (LM_ARCH, "prefill", 4, 2048))  # phase 9's
COUNT_STEPS = 5  # (b): timed steps, median
BASELINE_SERIES, BASELINE_SAMPLES = 4, 65536
BASELINE_EPS = (1e-2, 1e-3)  # of each row's range
BASELINE_CPU_DECODE_ROWS = 1  # rows whose decodes are also compared with the CPU route's
_children: list[subprocess.Popen] = []


@atexit.register
def _stop_children() -> None:
    for p in _children:
        if p.poll() is None:
            p.kill()
            p.wait()


def start_dryruns(tmp: pathlib.Path) -> dict:
    """(a): ``python -m repro_torch.launch.dryrun`` for each sweep, one
    subprocess each, all at once, with no card (``CUDA_VISIBLE_DEVICES``
    empty); output in ``tmp``."""
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    jobs = {}
    for name, args in DRYRUN_SWEEPS.items():
        out = tmp / name
        out.mkdir(parents=True)
        log = open(tmp / f"{name}.log", "w")
        p = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", *args,
                              "--out", str(out)], env=env, stdout=log, stderr=subprocess.STDOUT)
        _children.append(p)
        jobs[name] = (out, tmp / f"{name}.log", time.perf_counter(), p)
    return jobs


def finish_dryruns(jobs: dict) -> dict:
    """(a): every sweep exits 0 within its time, every cell is written and
    no ``FAILED__`` file appears; each cell's dominant term and fit, and
    each sweep's wall from its start to its own end (polled every 0.1 s)."""
    ends: dict = {}
    while len(ends) < len(jobs):
        for name, (_, _, t0, p) in jobs.items():
            if name in ends:
                continue
            if p.poll() is not None:
                ends[name] = time.perf_counter()
            elif time.perf_counter() - t0 > DRYRUN_TIMEOUT:
                p.kill()
                fail(f"dry run {name}: no end within {DRYRUN_TIMEOUT} s")
        time.sleep(0.1)
    stats = {}
    for name, (out, log, t0, p) in jobs.items():
        wall = ends[name] - t0
        failed = sorted(f.name for f in out.glob("FAILED__*"))
        check(p.returncode == 0 and not failed,
              f"dry run {name}: exit {p.returncode}, failed {failed}\n" + log.read_text()[-3000:])
        cells = {f.stem: json.loads(f.read_text()) for f in sorted(out.glob("*.json"))}
        want = 1 if name == "compressed" else 32
        check(len(cells) == want, f"dry run {name}: {len(cells)} cells, not {want}")
        stats[name] = {"cells": len(cells), "wall_s": wall, "cells_s": {
            k: c["seconds"]["trace"] for k, c in cells.items()}, "cell": {
            k: {"dominant": c["roofline"]["dominant"], "fits": c.get("memory", {}).get("fits"),
                "compute_s": c["roofline"]["compute_s"], "memory_s": c["roofline"]["memory_s"],
                "collective_s": c["roofline"]["collective_s"],
                "flops_per_device": c.get("cost", {}).get("flops_per_device"),
                "useful_flops_ratio": c["roofline"].get("useful_flops_ratio"),
                "argument_bytes": c.get("memory", {}).get("argument_bytes"),
                "temp_bytes": c.get("memory", {}).get("temp_bytes"),
                "collective_bytes": c.get("collectives", {}).get("by_type")}
            for k, c in cells.items()}}
        if name == "compressed":
            (c,) = cells.values()
            stats[name]["exchange_bytes"] = {k: v["collective_bytes"]
                                             for k, v in c["exchange"].items()}
    return stats


def _count_key(c) -> tuple:
    return c.flops, c.bytes, c.dot_count, c.kernels


def count_step(CA, DR, TS, opt_mod, build_model, cfg, kind: str, b: int, s: int, seed: int,
               dev) -> tuple[dict, dict]:
    """(b): one step counted on meta, then on the card from random params
    (the counts must be equal), then timed.  Returns the stats and the
    step's launches of the flash kernels (counted and timed runs)."""
    import gc

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import ops

    m = build_model(cfg)
    shape = ShapeSpec(f"{kind}_{b}x{s}", s, b, kind)
    train = kind == "train"
    grad = contextlib.nullcontext() if train else torch.no_grad()
    step = TS.make_train_step(m) if train else TS.make_prefill_step(m)

    def args(params, batch):
        return (params, opt_mod.adamw_init(params), batch) if train else (params, batch)

    meta_params = m.init_shapes(seed)
    with grad:
        (_, meta), meta_s = sync_time(lambda: CA.analyze_step(step, *args(
            meta_params, m.input_specs(shape))))
    params = m.init(seed, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    batch = {k: torch.randint(0, cfg.vocab_size, v.shape, generator=g, device=dev,
                              dtype=v.dtype) for k, v in m.input_specs(shape).items()}
    before = dict(ops.launches)
    with grad:
        _, card = CA.analyze_step(step, *args(params, batch))
    if _count_key(card) != _count_key(meta):
        diff = {op: (meta.by_op.get(op), card.by_op.get(op))
                for op in set(meta.by_op) | set(card.by_op)
                if meta.by_op.get(op) != card.by_op.get(op)}
        print("count differences by op (meta, card): " + json.dumps(diff), flush=True)
        fail(f"(b) {cfg.name} {kind}: the card's count {_count_key(card)} differs from "
             f"meta's {_count_key(meta)}")
    state = args(params, batch)
    times = []
    with grad:
        for _ in range(COUNT_STEPS):
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = step(*state)
            stop.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(stop) / 1e3)
            if train:
                state = (out[0], out[1], batch)
            del out
    launches = {k: ops.launches[k] - before[k] for k in ("flash_attention",
                                                         "flash_attention_bwd")}
    del state, params, batch
    gc.collect()
    torch.cuda.empty_cache()
    step_s = float(np.median(times))
    compute_s, memory_s = card.flops / 989e12, card.bytes / HBM_BYTES_PER_S
    bound_s = max(compute_s, memory_s)
    mft = DR.model_flops_total(cfg, shape)
    return {"arch": cfg.name, "kind": kind, "batch": [b, s], "layers": cfg.n_layers,
            "flops": card.flops, "bytes": card.bytes, "dot_count": card.dot_count,
            "kernels": card.kernels, "counts_equal_meta": True,
            "peak_live_bytes": {"meta": meta.peak_live_bytes, "card": card.peak_live_bytes},
            "meta_count_s": meta_s, "step_s": times, "median_step_s": step_s,
            "compute_s": compute_s, "memory_s": memory_s, "bound_s": bound_s,
            "bound_by": "operations" if compute_s >= memory_s else "bytes",
            "share_of_eager_traffic_bound": bound_s / step_s, "model_flops_total": mft,
            "model_flops_share": mft / (step_s * 989e12),
            "top_ops_by_bytes": dict(sorted(card.by_op.items(),
                                            key=lambda kv: -kv[1][2])[:6])}, launches


def baselines_on_card(P, B, ops, seed: int, dev) -> tuple[dict, dict]:
    """(c): ``gateway_batch(4, 65536)`` through every registry entry on the
    card: lossy at BASELINE_EPS of each row's range (within the reference
    test's bound), lossless at the gateway's decimals (bit-exact; GD equal
    at its decimals); every blob equal to the CPU route's, and the first
    row's decodes equal to the CPU route's bit for bit.  Each method's
    ratio (16 B a row, the paper's) and seconds beside SHRINK's on the
    same rows.  Returns the stats and the rANS launches (TRC)."""
    values = gateway_batch(BASELINE_SERIES, BASELINE_SAMPLES, seed)
    codec = P.ShrinkCodec.from_fraction(values, frac=0.05, device=dev)
    n = values.size
    cases = [(f"{name} eps {frac}", B.LOSSY[name], B.LOSSY_D[name], frac)
             for frac in BASELINE_EPS for name in B.LOSSY]
    cases += [(f"{name} lossless", B.LOSSLESS[name], B.LOSSLESS_D[name], None)
              for name in B.LOSSLESS]
    stats = {k: {"bytes": 0, "compress_s": 0.0, "decompress_s": 0.0} for k, *_ in cases}
    shrink = {f"eps {frac}": 0 for frac in BASELINE_EPS} | {"lossless": 0}
    before = dict(ops.launches)
    for i, row in enumerate(values):
        v = torch.as_tensor(row, device=dev)
        vc = torch.from_numpy(row)
        span = float(row.max() - row.min())
        for key, enc, dec, frac in cases:
            arg = DECIMALS if frac is None else frac * span
            blob, t_c = sync_time(lambda: enc(v, arg))
            out, t_d = sync_time(lambda: dec(blob, device=dev))
            check(blob == enc(vc, arg), f"(c) {key} row {i}: the CPU route's bytes differ")
            check(out.device == v.device and out.dtype == torch.float64 and out.shape == v.shape,
                  f"(c) {key}: decode {out.dtype} {tuple(out.shape)} on {out.device}")
            if frac is not None:
                err = float((out - v).abs().max())
                check(err <= frac * span * (1 + 1e-3) + 1e-9, f"(c) {key} row {i}: error {err}")
            elif key.startswith("GD "):
                check(torch.equal(torch.round(out, decimals=DECIMALS), v),
                      f"(c) {key} row {i}: differs at {DECIMALS} decimals")
            else:
                check(same_bits(out, v), f"(c) {key} row {i}: not bit-exact")
            if i < BASELINE_CPU_DECODE_ROWS:
                check(same_bits(out.cpu(), dec(blob, device="cpu")),
                      f"(c) {key}: the card's decode differs from the CPU route's")
            s = stats[key]
            s["bytes"] += len(blob)
            s["compress_s"] += t_c
            s["decompress_s"] += t_d
        for frac in BASELINE_EPS:
            shrink[f"eps {frac}"] += len(P.cs_to_bytes(codec.compress(v, [frac * span],
                                                                      decimals=DECIMALS)))
        shrink["lossless"] += len(P.cs_to_bytes(codec.compress(v, [0.0], decimals=DECIMALS)))
    launches = {k: ops.launches[k] - before[k] for k in ("rans_encode", "rans_decode")}
    for s in stats.values():
        s["ratio"] = P.BYTES_PER_ROW * n / s["bytes"]
    return {"rows": [BASELINE_SERIES, BASELINE_SAMPLES], "methods": stats,
            "shrink_ratio": {k: P.BYTES_PER_ROW * n / b for k, b in shrink.items()},
            "trc_rans_launches": launches}, launches


def dryrun_path(P, ops, get_config, seed: int, dev, meanwhile=None) -> tuple[dict, dict]:
    """Phase 15: (b) the two steps counted on the card and on meta, (c) the
    baselines on the card, then (a) the dry-run sweeps, all three at once
    on the host, with ``meanwhile(tmp)`` (other work on the host's CPU, its
    result under ``"meanwhile"``) run on a thread beside them.  (a)'s
    ``phase_s`` runs from the sweeps' start to the last one's end, and
    ``meanwhile``'s result keeps its own wall: the two share the host's
    cores, so neither is a time alone.  Returns the stats and the launches
    of (b)'s flash kernels and (c)'s rANS ones."""
    import repro_torch.baselines as B
    from repro_torch.launch import cost_analysis as CA
    from repro_torch.launch import dryrun as DR
    from repro_torch.models import build_model
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import train_step as TS

    stats, launches = {"b": {}}, {}
    for arch, kind, b, s in COUNT_CELLS:
        (st, fl), wall = sync_time(lambda: count_step(CA, DR, TS, opt_mod, build_model,
                                                      get_config(arch), kind, b, s, seed, dev))
        st["phase_s"] = wall
        stats["b"][f"{arch} {kind}"] = st
        for k, v in fl.items():
            launches[k] = launches.get(k, 0) + v
        print(f"dry-run check (b) {arch} {kind}: " + json.dumps(st), flush=True)
    check(launches["flash_attention"] > 0 and launches["flash_attention_bwd"] > 0,
          f"(b) launched no flash kernel: {launches}")
    (stats["c"], rans), wall = sync_time(lambda: baselines_on_card(P, B, ops, seed, dev))
    stats["c"]["phase_s"] = wall
    print("baselines (c): " + json.dumps(stats["c"]), flush=True)
    # TRC's byte planes take the rANS coder where zstd does not import (the card machine)
    check(B.standard._zstd is not None or all(rans.values()),
          f"(c) TRC launched no rANS kernel: {rans}")
    launches |= rans
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    try:
        t0 = time.perf_counter()
        jobs = start_dryruns(tmp / "sweeps")
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            side = None if meanwhile is None else pool.submit(meanwhile, tmp / "meanwhile")
            stats["a"] = finish_dryruns(jobs)
            stats["a"]["phase_s"] = time.perf_counter() - t0
            if side is not None:
                stats["meanwhile"] = side.result()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if meanwhile is not None:
        stats["a"]["beside"] = {"what": meanwhile.__name__,
                                "wall_s": stats["meanwhile"].get("wall_s")}
    print("dry run (a): " + json.dumps(stats["a"]), flush=True)
    return stats, launches


# ---------------------------------------------------------------- phase 16
# sharded state and tensor parallelism: (a) and (b) on a one-rank NCCL mesh,
# (c) on 4 gloo ranks on the CPU, (d) the dense cells of phase 15's dry-run
# sweep
TP_KV = (1, 2)  # (c): kv heads replicated over "model" (1), split (2)
# (c): the expert-parallel MoE's top-2 case, held to one device in float32
# only (its near-uniform router flips experts under bf16 TP rounding); the
# compressed step on a sharded state, (pod 2, data 2) ("pod", "data", "model")
TP_FLOAT32_ONLY = ("mla_ep_k2",)
TP_COMPRESSED = {"pod2_data2": (2, 2, 1)}
# (c): the families' train cases (tests/torch_tp_case.py's FAMILY_CASES) and
# their meshes: 2 x 2, and 1 x 4 for llama4's 6 heads that 4 does not divide
# (force_head_sharding: 2, 2, 2 and 0 heads a rank); the one-rank vocabulary
# of 510 and the (2, 2) head split run in the tests only
TP_FAMILY_MESH = {"heads6": (1, 4)}
TP_FAMILY_SKIP = ("uneven", "heads5")
# (f): the other families at phase 12's full width on a one-rank mesh; the
# train step on the first group of layers, FAMILY_TRAIN_ROWS x FAMILY_LEN;
# llama4's train step at 2 experts (its widths kept): 128 experts' bf16
# weights and float32 AdamW moments (~190 GB a layer) do not fit one card
FAMILY_TRAIN_ROWS = 2
FAMILY_TRAIN_EXPERTS = {"llama4-maverick-400b-a17b": 2}
# (f): the flash pair at a rank's shapes under 16-way TP (q shape, kv heads,
# V's width before its zero padding): deepseek 1 MLA head at d 192, the VLM
# 2 of its 32 heads (8 kv heads stay whole: each rank reads 1), seamless 1
# head of 64 over its decoder's 1024 tokens; llama4's 40 heads forced over
# 16 ranks in GSPMD's tiles of 3 (8 kv heads whole): ranks 0-12 hold 3 heads
# on 1 kv head (a tile inside one group of 5, heads 0-2) or on 3 (a tile
# across two groups, heads 3-5 read kv 0, 0, 1: one kv head a query head),
# rank 13 head 39 alone
TP16_FLASH = {"deepseek-v2-lite-16b": ((FAMILY_BATCH, FAMILY_LEN, 1, 192), 1, 128),
              "llama-3.2-vision-11b": ((FAMILY_BATCH, FAMILY_LEN, 2, 128), 1, 128),
              "seamless-m4t-medium": ((FAMILY_BATCH, FAMILY_LEN // 2, 1, 64), 1, 64),
              "llama4-maverick-400b-a17b 3 heads on 1": (
                  (FAMILY_BATCH, FAMILY_LEN, 3, 128), 1, 128),
              "llama4-maverick-400b-a17b 3 heads on 3": (
                  (FAMILY_BATCH, FAMILY_LEN, 3, 128), 3, 128),
              "llama4-maverick-400b-a17b 1 head on 1": (
                  (FAMILY_BATCH, FAMILY_LEN, 1, 128), 1, 128)}
# (d): the five families' dry-run cells before their tensor parallelism (GiB
# of a rank's arguments + peak temporaries, 16x16; launch/dryrun.py --all on
# the tree before it, PERF.md section 6)
FAMILY_DRY_BEFORE = {
    "deepseek-v2-lite-16b": {"train_4k": (0.62, 146.41), "prefill_32k": (0.12, 6.91),
                             "decode_32k": (0.60, 0.81)},
    "recurrentgemma-9b": {"train_4k": (0.38, 401.45), "prefill_32k": (0.08, 56.58),
                          "decode_32k": (0.09, 4.03)},
    "rwkv6-1.6b": {"train_4k": (0.08, 87.25), "prefill_32k": (0.03, 18.51),
                   "decode_32k": (0.04, 1.03)},
    "seamless-m4t-medium": {"train_4k": (0.17, 158.90), "prefill_32k": (0.14, 6.56),
                            "decode_32k": (0.76, 2.02)},
    "llama-3.2-vision-11b": {"train_4k": (0.76, 179.74), "prefill_32k": (0.12, 21.61),
                             "decode_32k": (2.60, 2.02)}}
# (d): the expert-parallel configs' train cells before their EP backward (GiB
# of a rank's arguments + peak temporaries, and collective bytes a step, on
# 16x16 and 2x16x16; launch/dryrun.py on the tree before it, PERF.md section 6):
# the sharded step then ran the dense dispatch, every expert gathered whole
EP_DRY_BEFORE = {
    "deepseek-v2-lite-16b": {"16x16": (0.62, 30.68, 1.384e11), "2x16x16": (0.62, 15.86, 1.024e11)},
    "llama4-maverick-400b-a17b": {"16x16": (14.48, 101.38, 1.886e12),
                                  "2x16x16": (7.24, 95.12, 3.277e12)}}
# (d): llama4's cells with its 40 heads whole on every model rank, before
# force_head_sharding split them (rank 0's flops a step, all-reduce bytes
# and GiB of peak temporaries, on 16x16 and 2x16x16; launch/dryrun.py on
# the tree before it, PERF.md section 6); the split must cut the flops at
# least HEADS_FLOPS_CUT-fold and keep the cell fitting a card
HEADS_DRY_BEFORE = {
    "train_4k": {"16x16": (2.516e15, 2.282e11, 48.04), "2x16x16": (1.258e15, 1.141e11, 24.08)},
    "prefill_32k": {"16x16": (1.534e15, 9.80e10, 25.26), "2x16x16": (7.669e14, 4.90e10, 12.63)}}
HEADS_FLOPS_CUT = 3.0
SHARDED_ROUNDS = 3  # (a): rounds of one device, sharded, control, control, sharded, one device
DENSE_ARCHS = ("qwen3-0.6b", "llama3-8b", "stablelm-12b", "command-r-35b")


def tp_gloo_ranks(tmp: pathlib.Path) -> dict:
    """(c): ``tests/torch_tp_case.py``'s cases (the configs, workers and
    bounds that ``tests/test_torch_tensor_parallel.py``,
    ``tests/test_torch_tensor_parallel_families.py`` and
    ``tests/test_torch_decode_parallel.py`` hold) against one device on
    this host's CPU, all on one launch of 4 gloo processes: the sharded
    train steps and prefill of the dense config for each kv case and of
    each family (llama4's 6 heads forced over a model axis of 4 on 1 x 4;
    deepseek's expert-parallel MoE, ``mla_ep``), then the dense prefill and
    6 sharded decode steps for each kv case, then the compressed step on a
    (pod 2, data 2) mesh against the whole-params step (and its exchange
    against ``compressed_psum_tree`` on whole leaves, bit for bit)."""
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_tp_case as TPC

    t0 = time.perf_counter()
    stats = {"ranks": 4, "mesh": {"data": 2, "model": 2}, "steps": TPC.STEPS, "config": TPC.TINY,
             "bounds": {"grad_rel": TPC.GRAD_REL, "param_rel": TPC.GRAD_REL,
                        "moved_rel": TPC.MOVED_REL, "loss_rel": TPC.LOSS_REL,
                        "gnorm_rel": TPC.GNORM_REL["bfloat16"], "logits": TPC.LOGIT_TOL,
                        "caches": TPC.CACHE_TOL, "families": TPC.FAMILY_BF16},
             "decode": {"prompt": TPC.PROMPT, "buffer": TPC.DECODE_LEN,
                        "steps": TPC.DECODE_STEPS}}
    train = {f"family {c}": (c, TP_FAMILY_MESH.get(c, (2, 2)), c)
             for c in TPC.FAMILY_CASES if c not in TP_FLOAT32_ONLY + TP_FAMILY_SKIP}
    train |= {f"kv {kv}": (kv, (2, 2), kv) for kv in TP_KV}
    stats["compressed_bounds"] = {"gnorm_rel": TPC.COMPRESSED_GNORM_REL,
                                  "min_leaf_size": TPC.COMPRESS["min_leaf_size"]}
    got = TPC.check_cases_in_one_launch(tmp / "tp", train, TP_KV, TP_COMPRESSED)
    for name, g in got.items():
        g = {k: v for k, v in g.items() if k != "local_shapes"}
        if name in train:
            g["mesh"] = train[name][1]
        check(g["within"], f"(c) {name}: the sharded steps off one device's: " + json.dumps(g))
        stats[name] = g
    stats["wall_s"] = time.perf_counter() - t0
    return stats


@contextlib.contextmanager
def local_collectives():
    """torch.distributed's collectives, as the steps call them on a
    one-rank mesh, replaced by what they compute there (a copy, or
    nothing): (a)'s control, which prices the collective calls."""
    import torch.distributed as dist

    names = ("all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce")
    saved = {n: getattr(dist, n) for n in names}

    def copy(out, x, *args, **kwargs):
        out.copy_(x)

    dist.all_gather_into_tensor = dist.reduce_scatter_tensor = copy
    dist.all_reduce = lambda *args, **kwargs: None
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(dist, n, fn)


def traced_collectives(fn) -> dict:
    """``fn()`` once under torch.profiler: its wall s, the collective calls
    and their host ms (``record_param_comms``; ``c10d`` ops), the NCCL
    kernels' and all device ms, and the host ms of the collectives'
    autograd Functions."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = sync_time(fn)
    ka = prof.key_averages()
    comm = [e for e in ka if e.key == "record_param_comms"]
    return {
        "wall_s": wall,
        "collective_calls": sum(e.count for e in comm),
        "collective_host_ms": sum(e.cpu_time_total for e in comm) / 1e3,
        "c10d_host_ms": sum(e.cpu_time_total for e in ka if e.key.startswith("c10d::")) / 1e3,
        "nccl_device_ms": sum(e.self_device_time_total for e in ka
                              if "nccl" in e.key.lower()) / 1e3,
        "device_ms": sum(e.self_device_time_total for e in ka) / 1e3,
        "functions_host_ms": {e.key: [e.count, e.cpu_time_total / 1e3] for e in ka
                              if e.key.lstrip("_").split("Backward")[0]
                              in ("Gather", "CopyTo", "ReduceFrom")}}


def sharded_in_turns(TS, opt_mod, m, params, placed, pipe, mesh, dev) -> dict:
    """(a)'s timing, on one batch, each from its own state: the one-device
    step, the sharded step, and the sharded step under
    :func:`local_collectives` (the control), one warm-up step each, then
    SHARDED_ROUNDS rounds of (one, sharded, control, control, sharded,
    one); every chain's losses equal.  Then one sharded step traced: its
    collective calls, their host time and their kernels' device time, and
    the host time of the collectives' autograd Functions."""
    b = train_batch(pipe, 0, dev)
    opt = opt_mod.AdamWConfig()
    steps = {"one_device": TS.make_train_step(m, None, opt),
             "sharded": TS.make_train_step(m, mesh, opt),
             "local_collectives": TS.make_train_step(m, mesh, opt)}
    states = {"one_device": (params, opt_mod.adamw_init(params)),
              "sharded": (placed, opt_mod.adamw_init(placed)),
              "local_collectives": (placed, opt_mod.adamw_init(placed))}
    times = {k: [] for k in steps}
    losses = {k: [] for k in steps}

    def run(name):
        ctx = local_collectives() if name == "local_collectives" else contextlib.nullcontext()
        with ctx:
            (p, o, metrics), t = sync_time(lambda: steps[name](*states[name], b))
        states[name] = (p, o)
        losses[name].append(float(metrics["loss"]))
        return t

    for name in steps:
        run(name)
    for _ in range(SHARDED_ROUNDS):
        for name in ("one_device", "sharded", "local_collectives", "local_collectives",
                     "sharded", "one_device"):
            times[name].append(run(name))
    traced = traced_collectives(lambda: run("sharded"))
    check(losses["sharded"][:-1] == losses["local_collectives"] == losses["one_device"],
          f"(a) the timed chains' losses differ: {losses}")
    medians = {k: float(np.median(v)) for k, v in times.items()}
    return {
        "rounds": SHARDED_ROUNDS, "step_s": times, "median_step_s": medians,
        "sharded_over_one_device": medians["sharded"] / medians["one_device"],
        "control_over_one_device": medians["local_collectives"] / medians["one_device"],
        "traced": traced}


def sharded_train(ops, TS, opt_mod, PP, place, m, params, pipe, mesh, one, dev) -> tuple:
    """(a): PAR_STEPS sharded steps on ``mesh`` from params placed by
    ``param_shardings`` (launches counted): loss, grad norm and every state
    leaf bit-equal to phase 14 (a)'s one-device run from the same seed."""
    from repro_torch.training._tree import leaves, tree_map

    placed = tree_map(lambda p, s: place(p, *s), params, PP.param_shardings(params, m.cfg, mesh))
    batches = [train_batch(pipe, s, dev) for s in range(PAR_STEPS)]
    step = TS.make_train_step(m, mesh, opt_mod.AdamWConfig())
    state = (placed, opt_mod.adamw_init(placed))
    times, losses, norms = [], [], []
    ops.reset_launches()
    for b in batches:
        (p, o, metrics), t = sync_time(lambda: step(*state, b))
        state = (p, o)
        times.append(t)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    launches = dict(ops.launches)
    placed_ok = all(t.placements == sh.placements for t, sh in zip(
        leaves(state[0]), leaves(PP.param_shardings(params, m.cfg, mesh)), strict=True))
    got = leaves(state)
    equal = sum(torch.equal(local(a).cpu(), b) for a, b in zip(got, one["state"], strict=True))
    check(placed_ok, "(a) the sharded step's params are not on their specs' placements")
    check(equal == len(got), f"(a) sharded step: {len(got) - equal} of {len(got)} state leaves "
          "differ from phase 14 (a)'s one-device run")
    check(losses == one["losses"] and norms == one["grad_norms"],
          f"(a) losses {losses} / grad norms {norms} vs {one['losses']} / {one['grad_norms']}")
    for name in ("flash_attention", "flash_attention_bwd"):
        check(launches[name] > 0, f"(a) the sharded step launched no {name}")
    del state, got
    stats = {"steps": PAR_STEPS, "batch": [TRAIN_BATCH, TRAIN_SEQ],
             "mesh": {"data": 1, "model": 1}, "state_leaves_equal": equal,
             "state_leaves": len(one["state"]), "losses": losses, "grad_norms": norms,
             "step_times_s": times, "median_step_s": float(np.median(times)),
             "phase_14a_median_step_s": one["median_step_s"],
             "launches": {k: v for k, v in launches.items() if v},
             "flash_launches_a_step": {k: launches[k] / PAR_STEPS
                                       for k in ("flash_attention", "flash_attention_bwd")}}
    stats["in_turns"] = sharded_in_turns(TS, opt_mod, m, params, placed, pipe, mesh, dev)
    return stats


def sharded_serve(ops, TS, PP, place, build_model, cfg, lm_logits, lm_decoded, batch: int,
                  length: int, seed: int, mesh, dev) -> tuple[dict, dict]:
    """(b): phase 9's prefill (the same seed, params and tokens) through the
    sharded ``make_prefill_step`` on ``mesh`` from params placed by
    ``param_shardings``: logits bit-equal to phase 9's.  (e): its caches
    (``cache_specs``' pieces: all of them on one rank) grafted into decode
    buffers of phase 9's length, then phase 9's decode steps (its tokens
    fed) through the sharded ``make_decode_step``: each step's logits
    bit-equal to phase 9's; the median step beside phase 9's, and one more
    step traced (collective calls, their host ms)."""
    from repro_torch.training._tree import tree_map

    m = build_model(cfg)
    params = m.init(seed, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (batch, length), generator=g, device=dev)
    placed = tree_map(lambda p, s: place(p, *s), params, PP.param_shardings(params, cfg, mesh))
    del params
    step = TS.make_prefill_step(m, mesh)
    with torch.inference_mode():
        ops.reset_launches()
        (logits, caches), prefill_s = sync_time(lambda: step(placed, {"tokens": toks}))
        launches = dict(ops.launches)
    check(launches["flash_attention"] == cfg.n_layers,
          f"(b) the sharded prefill launched flash_attention {launches['flash_attention']} "
          f"times, not once a layer ({cfg.n_layers})")
    pc = caches["groups"]["pos0"]["self"]
    check(tuple(pc.k.shape) == (cfg.n_layers, batch, length, cfg.n_kv_heads,
                                cfg.resolved_head_dim), f"(b) caches {tuple(pc.k.shape)}")
    logits = logits.to_local()
    equal = torch.equal(logits.cpu(), lm_logits)
    check(equal, "(b) the sharded prefill's logits differ from phase 9's, max |diff| "
          f"{float((logits.cpu().float() - lm_logits.float()).abs().max())}")
    b = {"arch": cfg.name, "batch": [batch, length], "mesh": {"data": 1, "model": 1},
         "logits_equal_phase_9": equal, "prefill_s": prefill_s,
         "launches": {k: v for k, v in launches.items() if v}}

    steps = len(lm_decoded["tokens"])
    decode = TS.make_decode_step(m, mesh)
    with torch.inference_mode():
        dec = m.make_decode_caches(batch, length + steps, device=dev)
        dc = dec["groups"]["pos0"]["self"]
        for f in ("k", "v", "kpos"):
            getattr(dc, f)[:, :, :length] = getattr(pc, f).to_local()
        del caches, pc
        equal_steps, step_s = 0, []
        for i, (tok, want) in enumerate(zip(lm_decoded["tokens"], lm_decoded["logits"])):
            (out, dec), dt = sync_time(lambda: decode(placed, tok.to(dev), dec, length + i))
            step_s.append(dt)
            equal_steps += torch.equal(out.to_local()[:, 0].cpu(), want)
        traced = traced_collectives(lambda: decode(placed, tok.to(dev), dec, length + steps - 1))
    check(equal_steps == steps, f"(e) {steps - equal_steps} of {steps} sharded decode steps' "
          "logits differ from phase 9's")
    median = float(np.median(step_s[1:] or step_s))
    e = {"arch": cfg.name, "batch": batch, "prompt_len": length, "steps": steps,
         "mesh": {"data": 1, "model": 1}, "steps_equal_phase_9": equal_steps,
         "step_s": step_s, "median_step_s": median,
         "phase_9_median_step_s": lm_decoded["median_step_s"],
         "over_phase_9": median / lm_decoded["median_step_s"], "traced_step": traced}
    del placed, dec
    return b, e


def dryrun_cells(dry: dict, archs: tuple, before: dict | None = None) -> dict:
    """(d): the ``train_4k``, ``prefill_32k`` and ``decode_32k`` cells of
    ``archs`` on 16x16 from phase 15 (a)'s sweep (meta tensors, the host's
    CPU): per-rank arguments, temporaries, fit and collective bytes, beside
    ``before``'s arguments and temporaries where given."""
    cells = dry["single-pod"]["cell"]
    out = {}
    for arch in archs:
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            c = cells[f"{arch}__{shape}__16x16"]
            out[f"{arch} {shape}"] = {
                "argument_gib": c["argument_bytes"] / 2**30, "temp_gib": c["temp_bytes"] / 2**30,
                "fits": c["fits"], "collective_bytes": c["collective_bytes"]}
            if before is not None:
                out[f"{arch} {shape}"]["before_argument_and_temp_gib"] = before[arch][shape]
    return out


def ep_train_cells(dry: dict) -> dict:
    """(d): the ``train_4k`` cells of the ``moe_ep`` configs on both meshes,
    run through EP (phase 15 (a)'s sweeps), beside :data:`EP_DRY_BEFORE`."""
    out = {}
    for arch, before in EP_DRY_BEFORE.items():
        for mesh, sweep in (("16x16", "single-pod"), ("2x16x16", "multi-pod")):
            c = dry[sweep]["cell"][f"{arch}__train_4k__{mesh}"]
            args, temp, coll = before[mesh]
            out[f"{arch} train_4k {mesh}"] = {
                "argument_gib": c["argument_bytes"] / 2**30, "temp_gib": c["temp_bytes"] / 2**30,
                "fits": c["fits"], "collective_bytes": sum(c["collective_bytes"].values()),
                "by_type": c["collective_bytes"], "before_argument_and_temp_gib": [args, temp],
                "before_collective_bytes": coll}
            check(c["fits"], f"(d) {arch} train_4k on {mesh} does not fit a card through EP")
    return out


def heads_cells(dry: dict) -> dict:
    """(d): llama4's ``train_4k`` and ``prefill_32k`` cells on both meshes
    (phase 15 (a)'s sweeps), its heads split over "model" in GSPMD's tiles
    (rank 0: 3 of 40), beside :data:`HEADS_DRY_BEFORE`: rank 0's flops a
    step must fall at least ``HEADS_FLOPS_CUT``-fold, and the cell fit."""
    out, arch = {}, "llama4-maverick-400b-a17b"
    for shape, meshes in HEADS_DRY_BEFORE.items():
        for mesh, (flops, all_reduce, temp) in meshes.items():
            sweep = "single-pod" if mesh == "16x16" else "multi-pod"
            c = dry[sweep]["cell"][f"{arch}__{shape}__{mesh}"]
            out[f"{arch} {shape} {mesh}"] = {
                "flops_per_device": c["flops_per_device"], "before_flops": flops,
                "flops_cut": flops / c["flops_per_device"],
                "useful_flops_ratio": c["useful_flops_ratio"],
                "collective_bytes": c["collective_bytes"], "before_all_reduce": all_reduce,
                "temp_gib": c["temp_bytes"] / 2**30, "before_temp_gib": temp, "fits": c["fits"]}
            check(flops >= HEADS_FLOPS_CUT * c["flops_per_device"],
                  f"(d) {arch} {shape} on {mesh}: flops {c['flops_per_device']} not "
                  f"{HEADS_FLOPS_CUT}x below {flops}")
            check(c["fits"], f"(d) {arch} {shape} on {mesh} does not fit a card")
    return out


def _local_tree(tree):
    """A cache tree's DTensors as their local tensors (whole on one rank)."""
    if isinstance(tree, dict):
        return {k: _local_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_local_tree(v) for v in tree]
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: _local_tree(getattr(tree, f.name))
                             for f in dataclasses.fields(tree)})
    return local(tree)


def train_cut(cfg):
    """(f)'s train model: the first group of layers (the leading dense
    layers and one block group; one encoder layer), phase 12's widths."""
    n_prefix = cfg.first_dense_layers if cfg.n_experts else 0
    changes = {"n_layers": n_prefix + len(cfg.block_group)}
    if cfg.n_enc_layers:
        changes["n_enc_layers"] = 1
    if cfg.name in FAMILY_TRAIN_EXPERTS:
        changes["n_experts"] = FAMILY_TRAIN_EXPERTS[cfg.name]
    return dataclasses.replace(cfg, **changes)


def sharded_family_train(ops, TS, PP, place, opt_mod, build_model, cfg, seed: int, mesh,
                         dev) -> tuple[dict, dict]:
    """(f)'s train step: one sharded step of the cut model on ``mesh`` from
    params placed by ``param_shardings``, every state leaf and metric
    bit-equal to the one-device step on the same params and batch (run
    first, its state kept on the host); a ``moe_ep`` config (deepseek,
    llama4) trains its experts through the expert-parallel MoE, as its
    rules say.  Returns (stats, flash launches)."""
    from repro_torch.models import layers as L
    from repro_torch.training._tree import leaves, tree_map

    sys.path.insert(0, str(ROOT / "tests"))
    from torch_tp_case import counting

    tc = train_cut(cfg)
    m = build_model(tc)
    params = m.init(seed, device=dev)
    batch = family_batch(tc, FAMILY_TRAIN_ROWS, FAMILY_LEN, seed, dev)
    batch["labels"] = torch.roll(batch["tokens"], -1, dims=1)
    opt = opt_mod.AdamWConfig()

    def fresh():
        """AdamW's first state, the moments' zeros as one float32 zero
        expanded (no memory: the update reads them and writes new ones; at
        full vocabulary the whole zeros and the new moments together do not
        fit beside the step)."""
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        moments = tree_map(lambda p: zero.expand(p.shape), params)
        return {"m": moments, "v": moments,
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    (p1, o1, m1), one_s = sync_time(lambda: TS.make_train_step(m, None, opt)(
        params, fresh(), batch))
    want, copy_s = sync_time(lambda: [t.cpu() for t in leaves((p1, o1))])
    want_m = {k: float(v) for k, v in m1.items()}
    del p1, o1
    torch.cuda.empty_cache()
    placed = tree_map(lambda p, s: place(p, *s), params, PP.param_shardings(params, tc, mesh))
    ops.reset_launches()
    with counting(L, "_moe_apply_ep") as ep_calls:
        (p2, o2, m2), sharded_s = sync_time(lambda: TS.make_train_step(m, mesh, opt)(
            placed, fresh(), batch))
    launches = {k: ops.launches[k] for k in ("flash_attention", "flash_attention_bwd")}
    if tc.moe_ep:  # deepseek and llama4 train their experts through EP
        check(len(ep_calls) > 0, f"(f) {cfg.name} train: the expert-parallel MoE did not run")
    got = leaves((p2, o2))
    # the card compares: each host leaf goes back to it, a leaf at a time
    equal, compare_s = sync_time(lambda: sum(torch.equal(local(a), b.to(dev))
                                             for a, b in zip(got, want, strict=True)))
    got_m = {k: float(v) for k, v in m2.items()}
    check(equal == len(want) and got_m == want_m,
          f"(f) {cfg.name} train: {len(want) - equal} of {len(want)} state leaves differ from "
          f"one device, metrics {got_m} vs {want_m}")
    del p2, o2, got, placed, params, want
    torch.cuda.empty_cache()
    return {"layers": tc.n_layers, "enc_layers": tc.n_enc_layers, "experts": tc.n_experts,
            "moe_ep": tc.moe_ep, "expert_parallel_moe_calls": len(ep_calls),
            "batch": [FAMILY_TRAIN_ROWS, FAMILY_LEN], "state_leaves_equal": equal,
            "metrics_equal": True, "loss": got_m["loss"], "one_device_s": one_s,
            "sharded_s": sharded_s, "state_to_host_s": copy_s, "compare_s": compare_s,
            "launches": launches}, launches


def sharded_family(ops, TS, PP, place, opt_mod, build_model, cfg, ref: dict, p12: dict,
                   seed: int, mesh, dev) -> tuple[dict, dict]:
    """(f), one family: phase 12's prefill of FAMILY_BATCH x FAMILY_LEN (the
    same seed, params and inputs) through the sharded ``make_prefill_step``
    on ``mesh``, logits bit-equal to phase 12's; phase 12's decode check
    (its prompt, capacity and tokens fed) through the sharded prefill and
    ``make_decode_step``, each step's logits bit-equal to phase 12's; then
    :func:`sharded_family_train`.  Each run's seconds beside phase 12's."""
    from repro_torch.training._tree import tree_map

    m = build_model(cfg)
    params = m.init(seed, device=dev)
    placed = tree_map(lambda p, s: place(p, *s), params, PP.param_shardings(params, cfg, mesh))
    batch = family_batch(cfg, FAMILY_BATCH, FAMILY_LEN, seed, dev)
    launches = {"flash_attention": 0, "flash_attention_bwd": 0}
    with torch.inference_mode():
        ops.reset_launches()
        (logits, caches), prefill_s = sync_time(lambda: TS.make_prefill_step(m, mesh)(
            placed, batch))
        launches["flash_attention"] += ops.launches["flash_attention"]
        del caches
        logits_equal = torch.equal(logits.to_local().cpu(), ref["logits"])
        check(logits_equal, f"(f) {cfg.name}: the sharded prefill's logits differ from phase "
              f"12's, max |diff| {float((logits.to_local().cpu().float() - ref['logits'].float()).abs().max())}")
        del logits
        mc = m
        if ref["capacity_factor"] != cfg.capacity_factor:
            mc = build_model(dataclasses.replace(cfg, capacity_factor=ref["capacity_factor"]))
        prompt, steps = ref["prompt"], len(ref["steps"])
        sub = dict(batch, tokens=batch["tokens"][:, :prompt])
        ops.reset_launches()
        _, pcaches = TS.make_prefill_step(mc, mesh)(placed, sub)
        launches["flash_attention"] += ops.launches["flash_attention"]
        dec = mc.make_decode_caches(FAMILY_BATCH, prompt + steps, device=dev)
        graft(dec, _local_tree(pcaches), prompt)
        del pcaches
        decode = TS.make_decode_step(mc, mesh)
        equal_steps, step_s = 0, []
        for i, (tok, want) in enumerate(zip(ref["fed"], ref["steps"])):
            (out, dec), dt = sync_time(lambda: decode(placed, tok.to(dev), dec, prompt + i))
            step_s.append(dt)
            equal_steps += torch.equal(out.to_local()[:, 0].cpu(), want)
        del dec, out
    check(equal_steps == steps, f"(f) {cfg.name}: {steps - equal_steps} of {steps} sharded "
          "decode steps' logits differ from phase 12's")
    del placed, params
    torch.cuda.empty_cache()
    train, train_launches = sharded_family_train(ops, TS, PP, place, opt_mod, build_model, cfg,
                                                 seed, mesh, dev)
    for k, v in train_launches.items():
        launches[k] += v
    median = float(np.median(step_s[1:] or step_s))
    return {"arch": cfg.name, "layers": cfg.n_layers, "mesh": {"data": 1, "model": 1},
            "prefill_logits_equal_phase_12": logits_equal, "prefill_s": prefill_s,
            "phase_12_prefill_s": p12["prefill_s"], "decode_prompt": prompt,
            "decode_steps_equal_phase_12": equal_steps, "decode_steps": steps,
            "decode_median_step_s": median,
            "phase_12_decode_median_step_s": p12["decode_step_median_s"],
            "decode_over_phase_12": median / p12["decode_step_median_s"], "train": train,
            "launches": launches}, launches


def check_flash_tp16(FA, seed: int, dev) -> dict:
    """(f): the flash forward and backward against their plain versions at a
    rank's shapes under 16-way TP (TP16_FLASH; random bf16 inputs from the
    seed), within the kernels' bounds; the padded V columns stay 0.  Each
    pair timed (CUDA events) beside its bound (the operations of the causal
    pairs at the bf16 peak, or q, k, v and the output over the memory
    rate), the plain forward's and SDPA's forward's time."""
    out = {}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for arch, (shape, kvh, v_dim) in TP16_FLASH.items():
        q, k, v, o, dout, lse = flash_bwd_case(FA, shape, kvh, v_dim, seed, dev)
        got = FA.flash_attention_cuda(q, k, v, causal=True)
        want = FA.flash_attention_plain(q, k, v, causal=True)
        err = float((got.float() - want.float()).abs().max())
        check(bool(torch.allclose(got.float(), want.float(), atol=FLASH_BF16_TOL,
                                  rtol=FLASH_BF16_TOL)),
              f"(f) flash_attention at {arch}'s 16-way shape: max err {err}")
        check(bool((got[..., v_dim:] == 0).all()), f"(f) {arch}: padded V columns not 0")
        bwd = FA.flash_attention_bwd_cuda(q, k, v, o, dout, True, lse=lse)
        plain = FA.flash_attention_bwd_plain(q, k, v, o, dout, True)
        errs = {}
        for name, x, w in zip(("dq", "dk", "dv"), bwd, plain):
            e, scale = float((x.float() - w.float()).abs().max()), float(w.float().abs().max())
            errs[name] = e / scale
            check(e <= FLASH_BWD_TOL * scale,
                  f"(f) flash_attention_bwd at {arch}'s 16-way shape, {name}: {e} over "
                  f"{FLASH_BWD_TOL} x {scale}")
        b, sq, h, d = shape
        pairs = b * h * sq * (sq + 1) // 2  # causal (q, k) pairs
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        out[arch] = {"q": list(shape), "kv_heads": kvh, "v_dim": v_dim, "fwd_max_abs_err": err,
                     "fwd_tolerance": FLASH_BF16_TOL, "bwd_rel_err": errs,
                     "bwd_tolerance": FLASH_BWD_TOL,
                     "route": FA.last_route["flash_attention_bwd"],
                     "fwd_ms": event_ms(lambda: FA.flash_attention_cuda(q, k, v, causal=True), 10),
                     "fwd_bound_ms": 1e3 * max(
                         4 * pairs * d / BF16_OPS_PER_S,
                         (2 * q.numel() + k.numel() + v.numel()) * 2 / HBM_BYTES_PER_S),
                     "fwd_plain_ms": event_ms(
                         lambda: FA.flash_attention_plain(q, k, v, causal=True), 1),
                     "sdpa_fwd_ms": event_ms(
                         lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True), 10),
                     "bwd_ms": event_ms(
                         lambda: FA.flash_attention_bwd_cuda(q, k, v, o, dout, True, lse=lse), 10),
                     "bwd_bound_ms": 1e3 * max(
                         10 * pairs * d / BF16_OPS_PER_S,
                         (3 * q.numel() + 2 * k.numel() + 2 * v.numel() + 2 * o.numel()) * 2
                         / HBM_BYTES_PER_S)}
        del q, k, v, o, dout, lse, got, want, bwd, plain, qt, kt, vt
        torch.cuda.empty_cache()
    return out


def sharded_families(ops, FA, get_config, refs: dict, seed: int, mesh, dev) -> tuple[dict, dict]:
    """(f): :func:`sharded_family` for each of phase 12's families (llama4
    cut as phase 12 cuts it), then the flash pair at 16-way TP shapes.
    Returns the stats and (f)'s flash launches."""
    import gc

    from repro_torch.models import build_model
    from repro_torch.parallel import partition as PP
    from repro_torch.parallel.sharding import place
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import train_step as TS

    stats, launches = {}, {"flash_attention": 0, "flash_attention_bwd": 0}
    for arch in FAMILIES:
        cfg = get_config(arch)
        if arch in FAMILY_LAYERS:
            cfg = dataclasses.replace(cfg, n_layers=FAMILY_LAYERS[arch])
        (st, got), wall = sync_time(lambda: sharded_family(
            ops, TS, PP, place, opt_mod, build_model, cfg, refs[arch]["_ref"], refs[arch],
            seed, mesh, dev))
        st["wall_s"] = wall
        for k, v in got.items():
            launches[k] += v
        print(f"sharded (f) {arch}: " + json.dumps(st), flush=True)
        stats[arch] = st
        gc.collect()
        torch.cuda.empty_cache()
    for k, v in launches.items():
        check(v > 0, f"(f) launched no {k}")
    stats["flash_tp16"] = check_flash_tp16(FA, seed, dev)
    print("sharded (f) flash at 16-way shapes: " + json.dumps(stats["flash_tp16"]), flush=True)
    return stats, launches


def sharded_path(ops, FA, get_config, one: dict, lm_logits, lm_decoded: dict, dry: dict,
                 tp_ranks: dict, families: dict, lm_batch: int, lm_len: int, seed: int,
                 dev) -> tuple[dict, dict, dict]:
    """Phase 16: (a), (b), (e) and (f) on the card, (c) (``tp_ranks``, run
    on the host's CPU during phase 15's sweeps) and (d).  Returns the stats,
    the launches of (a) and (b)'s flash kernels and (f)'s."""
    import gc

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import build_model
    from repro_torch.parallel import partition as PP
    from repro_torch.parallel.sharding import place
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import train_step as TS

    stats = {}
    one_rank_group(dev)
    try:
        mesh = init_device_mesh(dev.type, (1, 1), mesh_dim_names=("data", "model"))
        cfg = get_config(PAR_ARCH)
        m = build_model(cfg)
        params = m.init(seed, device=dev)
        pipe = TokenPipeline(vocab_size=cfg.vocab_size, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ)
        stats["a"], a_s = sync_time(lambda: sharded_train(ops, TS, opt_mod, PP, place, m,
                                                          params, pipe, mesh, one, dev))
        stats["a"]["phase_s"] = a_s
        print("sharded (a) train step: " + json.dumps(stats["a"]), flush=True)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        (stats["b"], stats["e"]), be_s = sync_time(lambda: sharded_serve(
            ops, TS, PP, place, build_model, get_config(LM_ARCH), lm_logits, lm_decoded,
            lm_batch, lm_len, seed, mesh, dev))
        stats["e"]["phase_s"] = be_s
        print("sharded (b) prefill: " + json.dumps(stats["b"]), flush=True)
        print("sharded (e) decode: " + json.dumps(stats["e"]), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        (stats["f"], f_launches), f_s = sync_time(lambda: sharded_families(
            ops, FA, get_config, families, seed, mesh, dev))
        stats["f"]["phase_s"] = f_s
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    stats["c"] = tp_ranks
    print("sharded (c) 4 gloo ranks: " + json.dumps(stats["c"]), flush=True)
    stats["d"] = dryrun_cells(dry, DENSE_ARCHS)
    print("sharded (d) dense dry-run cells, 16x16: " + json.dumps(stats["d"]), flush=True)
    stats["d_families"] = dryrun_cells(dry, tuple(FAMILY_DRY_BEFORE), FAMILY_DRY_BEFORE)
    print("sharded (d) the families' dry-run cells, 16x16: " + json.dumps(stats["d_families"]),
          flush=True)
    stats["d_ep"] = ep_train_cells(dry)
    print("sharded (d) the moe_ep configs' train cells through EP: " + json.dumps(stats["d_ep"]),
          flush=True)
    stats["d_heads"] = heads_cells(dry)
    print("sharded (d) llama4's cells, heads split unevenly over 16: "
          + json.dumps(stats["d_heads"]), flush=True)
    launches = {k: stats["a"]["launches"].get(k, 0) + stats["b"]["launches"].get(k, 0)
                for k in ("flash_attention", "flash_attention_bwd")}
    return stats, launches, f_launches


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--series", type=int, default=1024)
    ap.add_argument("--samples", type=int, default=16384)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ragged-series", type=int, default=1024)
    ap.add_argument("--kv-batch", type=int, default=4)
    ap.add_argument("--gw-series", type=int, default=256)
    ap.add_argument("--gw-samples", type=int, default=131072)
    ap.add_argument("--gw-range-queries", type=int, default=1024)
    ap.add_argument("--gw-analytics-queries", type=int, default=768)
    ap.add_argument("--lm-batch", type=int, default=4)
    ap.add_argument("--lm-len", type=int, default=2048)
    ap.add_argument("--lm-decode", type=int, default=16)
    ap.add_argument("--trace", type=pathlib.Path, default=None,
                    help="also time the main path by stage and profile it; write to this dir")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs an NVIDIA card")
    if not (SRC / "repro_torch").is_dir():
        fail(f"the port's package is missing: {SRC / 'repro_torch'}")
    sys.path.insert(0, str(SRC))
    import repro_torch.core as P
    from repro_torch.configs import get_config
    from repro_torch.core import entropy as E
    from repro_torch.core import tensorshrink as T
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import base_fit as BF
    from repro_torch.kernels import cone_scan as cs_mod
    from repro_torch.kernels import dequant as DQ
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import interval_stats as IS
    from repro_torch.kernels import rans as rk
    from repro_torch.kernels import residual_quant as RQ
    from repro_torch.kernels import segment_agg as SA
    from repro_torch.launch import serve
    from repro_torch.models import layers as P_layers
    from repro_torch.serving import kvcache as KV

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _, build_s = sync_time(_build.build_all)
    print(f"kernels built in {build_s:.1f} s", flush=True)
    # phase 2: the main path, with the kernels' inputs recorded
    values = gateway_batch(args.series, args.samples, args.seed)
    recs = [Recorder(ops, "cone_scan"), Recorder(rk, "encode_rows"), Recorder(rk, "decode_rows")]
    ops.reset_launches()
    stats = main_path(P, values, dev, ops.launches)
    launches = dict(ops.launches)
    for rec in recs:
        rec.restore()
    print("main path: " + json.dumps({k: v for k, v in stats.items()
                                      if k not in ("codec", "blobs")}), flush=True)
    for name in ("cone_scan", "rans_encode", "rans_decode"):
        check(launches[name] > 0, f"kernel {name} was not launched on the main path")

    # phase 3: each kernel against its plain version, on the main path's inputs
    (x, eps, _lengths), _ = recs[0].args
    rows = [check_cone_scan(cs_mod, x, eps, launches["cone_scan"])]
    rows += check_rans(rk, recs[1].args[0], recs[2].args, launches)
    del x, eps, recs
    torch.cuda.empty_cache()

    # phase 4: the CPU route gives the same bytes as the card
    cpu = P.ShrinkCodec(stats["codec"].config, backend="rans", device="cpu")
    cpu_blobs = [P.cs_to_bytes(cs) for cs in cpu.compress_batch(values[:8], TIERS,
                                                                decimals=DECIMALS)]
    check(cpu_blobs == stats["blobs"][:8], "CPU route bytes differ from the card's")
    dry = np.where(values[8:16] > values[8:16, :1], np.round(values[8:16] - values[8:16, :1], 4),
                   -0.0)
    dry[::2] = np.where(np.arange(dry.shape[1]) % 3 == 0, 0.0, dry[::2])
    card_dry = [P.cs_to_bytes(cs) for cs in stats["codec"].compress_batch(dry, TIERS, DECIMALS)]
    check(card_dry == [P.cs_to_bytes(cs) for cs in cpu.compress_batch(dry, TIERS, DECIMALS)],
          "non-negative rows with zeros: CPU route bytes differ from the card's")
    print("cpu route: 8 series and 8 non-negative ones with zeros, SHRK bytes identical",
          flush=True)

    # phase 5: golden fixtures on the card
    print("golden: " + ", ".join(check_golden(P, dev)) + " identical", flush=True)

    # phase 6: the ragged gateway through the default backend
    ragged = ragged_path(P, E, ops, cs_mod, ragged_walks(args.ragged_series, args.seed), dev)
    rows[0]["launches_by_path"] = {"gateway": launches["cone_scan"],
                                   "ragged": ragged["launches"]["cone_scan"]}
    rows[0]["masked"] = ragged["masked_scan"]
    rows[0].update(ragged["masked_total"])
    print("ragged: " + json.dumps(ragged), flush=True)
    torch.cuda.empty_cache()

    # phase 7: the KV store at llama3-8b width
    kv, kv_rows = kv_path(T, KV, P_layers, ops, RQ, DQ, BF, args.kv_batch, args.seed, dev)
    rows += kv_rows
    print("kv store: " + json.dumps(kv), flush=True)
    torch.cuda.empty_cache()

    # phase 8: the streamed gateway, range serving and analytics
    _, sa_rows = streamed_path(P, SA, args.gw_series, args.gw_samples, args.gw_range_queries,
                               args.gw_analytics_queries, args.seed, dev, args.trace)
    rows += sa_rows
    torch.cuda.empty_cache()

    # phase 9: llama3-8b at full width and depth: prefill through the flash
    # kernel, decode after prefill, the CPU route, then serve --mode model
    lm, flash_row, lm_logits, lm_decoded = model_path(ops, FA, get_config(LM_ARCH),
                                                      args.lm_batch, args.lm_len, args.lm_decode,
                                                      args.seed, dev, args.trace)
    rows.append(flash_row)
    print("model: " + json.dumps(lm), flush=True)
    torch.cuda.empty_cache()
    print("serve model: " + json.dumps(serve_model_path(serve, LM_ARCH)), flush=True)
    torch.cuda.empty_cache()

    # phase 10: the kernel surface (pyramid_quant, pyramid_reconstruct,
    # interval_stats) at the KV store's and the gateway's shapes
    (surf, surf_rows), phase_s = sync_time(lambda: surface_path(
        ops, T, RQ, DQ, IS, P_layers, serve, args.kv_batch, args.gw_series, args.gw_samples,
        args.seed, dev))
    surf["phase_s"] = phase_s
    rows += surf_rows
    print("kernel surface: " + json.dumps(surf), flush=True)
    torch.cuda.empty_cache()

    # phase 11: the serving tier (ragged ingest, KB store, chaos, fleet)
    serving, phase_s = sync_time(lambda: serving_path(P, ops, serve, args.seed, dev))
    print(f"serving tier: {phase_s:.3f} s, launches " + json.dumps(serving["launches"]),
          flush=True)
    for row in rows:
        if row["name"] in SERVING_KERNELS:
            row["launches_serving_tier"] = serving["launches"][row["name"]]
    torch.cuda.empty_cache()

    # phase 12: models slice B at full width (MLA and MoE, llama4's
    # interleaved MoE, RG-LRU, RWKV6, cross-attention and the encoder)
    (families, mla), phase_s = sync_time(lambda: families_path(ops, FA, serve, get_config,
                                                               args.seed, dev, args.trace))
    print(f"models slice B: {phase_s:.3f} s", flush=True)
    flash_row["launches_by_path"] = {"dense prefill (phase 9)": flash_row["launches"]} | {
        f"{arch} prefill (phase 12)": st["flash_launches"] for arch, st in families.items()}
    flash_row["mla"] = mla
    print("flash_attention at the MLA shape: " + json.dumps(mla), flush=True)

    torch.cuda.empty_cache()

    # phase 13: training at qwen3-0.6b's full width and depth (the flash
    # backward, the train step, checkpoints, crash and resume, the
    # compressed exchange, the codec in training)
    (train_stats, bwd_row), phase_s = sync_time(lambda: training_path(ops, FA, BF, args.seed,
                                                                      dev, args.trace))
    print(f"training: {phase_s:.3f} s", flush=True)
    rows.append(bwd_row)
    flash_row["launches_by_path"]["train (phase 13)"] = train_stats["entry_point"][
        "launches"]["flash_attention"]
    comp = train_stats["compressed"]
    for row in rows:
        if row["name"] == "base_fit":  # (e)'s whole-params and sharded runs
            row.setdefault("launches_by_path", {})["compressed step (phase 13)"] = (
                comp["base_fit_launches"] + comp["sharded_base_fit_launches"])
    torch.cuda.empty_cache()

    # phase 14: the parallel layer on a DeviceMesh (data- and expert-parallel
    # steps, the cross-pod exchange, mesh checkpoints, dots remat)
    (_, par_launches, par_one), phase_s = sync_time(lambda: parallel_path(ops, get_config,
                                                                           args.seed, dev))
    print(f"parallel: {phase_s:.3f} s, launches " + json.dumps(par_launches), flush=True)
    for row in rows:
        if row["name"] in par_launches:
            check(par_launches[row["name"]] > 0, f"phase 14 launched no {row['name']}")
            row.setdefault("launches_by_path", {})["parallel (phase 14)"] = par_launches[
                row["name"]]
    torch.cuda.empty_cache()

    # phase 15: the dry run (two steps counted on the card against meta,
    # then the sweeps on the CPU) and the paper's baselines on the card
    (dry_stats, dry_launches), phase_s = sync_time(lambda: dryrun_path(
        P, ops, get_config, args.seed, dev, meanwhile=tp_gloo_ranks))
    print(f"dry run and baselines: {phase_s:.3f} s, launches " + json.dumps(dry_launches),
          flush=True)
    for row in rows:
        if row["name"] in ("flash_attention", "flash_attention_bwd"):
            row.setdefault("launches_by_path", {})["dry-run check (phase 15)"] = dry_launches[
                row["name"]]
        elif row["name"] in ("rans_encode", "rans_decode"):
            row.setdefault("launches_by_path", {})["baselines (phase 15)"] = dry_launches[
                row["name"]]
    torch.cuda.empty_cache()

    # phase 16: sharded state and tensor parallelism (the sharded train step
    # and prefill on a one-rank NCCL mesh, 4 gloo ranks, the dense dry-run cells)
    (_, tp_launches, f_launches), phase_s = sync_time(lambda: sharded_path(
        ops, FA, get_config, par_one, lm_logits, lm_decoded, dry_stats["a"],
        dry_stats.pop("meanwhile"), families, args.lm_batch, args.lm_len, args.seed, dev))
    del par_one, lm_decoded, families
    print(f"{smi}: sharded state and tensor parallelism: {phase_s:.3f} s, launches "
          + json.dumps(tp_launches) + ", (f) " + json.dumps(f_launches), flush=True)
    for row in rows:
        if row["name"] in tp_launches:
            check(tp_launches[row["name"]] > 0, f"phase 16 launched no {row['name']}")
            check(f_launches[row["name"]] > 0, f"phase 16 (f) launched no {row['name']}")
            row.setdefault("launches_by_path", {})["sharded (phase 16)"] = tp_launches[
                row["name"]]
            row["launches_by_path"]["sharded families (phase 16)"] = f_launches[row["name"]]
    torch.cuda.empty_cache()

    if args.trace is not None:
        trace = trace_main_path(P, values, stats["codec"], dev, args.trace)
        print("trace: " + json.dumps(trace), flush=True)

    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
