"""The operation and byte counts of the per-layer metrics against numbers
worked by hand for one small shape each, and the readers on made-up
traces."""
from __future__ import annotations

import types

import pytest

from conftest import TINY_DENSE, TINY_MOE
from harness import common
from harness.peaks import BF16_FLOPS, HBM_BYTES_PER_S
from harness.trace import TraceSummary, busy_union

MFU = common.load_module("metrics", "mfu.prefill")
MATMUL = common.load_module("metrics", "matmul_roofline.prefill")
FLASH = common.load_module("metrics", "flash_fwd_roofline.prefill")
RQ = common.load_module("metrics", "residual_quant_roofline.kv")
DQ = common.load_module("metrics", "dequant_roofline.kv")
IDLE = common.load_module("metrics", "device_idle.prefill")


def test_model_flops_dense_by_hand():
    # a layer: attention 2*64*64 + 2*64*32 = 12288, MLP 3*64*128 = 24576 parameters;
    # 2 layers x 10 tokens x 2 = 1,474,560; attention 2 x 4 heads x 32 x 10 x 11
    # = 28,160; the head on one position 2 * 64 * 512 = 65,536
    assert MFU.model_flops(TINY_DENSE, 10) == 1_474_560 + 28_160 + 65_536


def test_model_flops_mla_moe_by_hand():
    # MLA: 64*96 + 64*32 + 64*8 + 32*64 + 32*64 + 64*64 = 16,896; the dense layer's
    # MLP 3*64*96 = 18,432; a MoE layer: router 64*8 + 3*64*32*(2 top + 2 shared) = 25,088
    per_token = (16_896 + 18_432) + 2 * (16_896 + 25_088)
    # attention: 4 heads x (24 + 16) x 10 x 11 x 3 layers
    assert MFU.model_flops(TINY_MOE, 10) == 2 * 10 * per_token + 52_800 + 65_536


def test_matmul_products_dense_by_hand():
    prods = MATMUL.products(TINY_DENSE, 10)
    assert len(prods) == 2 * 7 + 1
    assert sum(2 * m * k * n for m, k, n, _, _ in prods) == 1_474_560 + 65_536
    assert prods[0] == (10, 64, 64, 1, 2)  # wq: 2 * (640 + 4096 + 640) bytes
    bound = MATMUL.bound_seconds({**TINY_DENSE, "n_layers": 0}, 10)  # the head alone
    assert bound == pytest.approx(max(2 * 64 * 512 / BF16_FLOPS,
                                      2 * (64 + 64 * 512 + 512) / HBM_BYTES_PER_S))


def test_matmul_products_moe_count_routed_rows_and_every_expert():
    prods = MATMUL.products(TINY_MOE, 10)
    experts = [p for p in prods if p[3] == 8]
    assert len(experts) == 3 * 2  # gate, up, down in each of the 2 MoE layers
    assert experts[0] == (20, 64, 32, 8, 2)  # 10 tokens x top 2 rows, 8 experts' weights
    router = [p for p in prods if p[4] == 4]
    assert router == [(10, 64, 8, 1, 4)] * 2


def test_flash_work_by_hand():
    # dense: 4 heads x 32 x 10 x 11 flops; q, k, v, o = 10 x (64 + 32 + 32 + 64) x 2 bytes
    assert FLASH.layer_work(TINY_DENSE, 10) == (14_080, 3_840)
    # MLA: 4 x (24 + 16) x 110; q, k at 24 and v, o at 16 on all 4 heads
    assert FLASH.layer_work(TINY_MOE, 10) == (17_600, 6_400)


def test_codec_bytes_by_hand():
    assert RQ.park_bytes(512, 256) == 2 * 512 + 512 + 8 * 2
    assert DQ.restore_bytes(512, 256) == 512 + 8 * 2 + 2 * 512
    assert RQ.park_bytes(257, 256) == 2 * 257 + 257 + 8 * 2


def _trace(ops: dict, busy: float = 1.0, window: float = 2.0) -> TraceSummary:
    return TraceSummary(window_s=window, busy_s=busy, device_ops=ops, top_ops=[], idle_gaps=[])


def test_readers_on_a_made_up_trace():
    ops = {"sm90_xmma_gemm_bf16bf16_tn": [2e-3, 3], "nvjet_hsh_128x256": [1e-3, 2],
           "void tc::flash_tc_kernel<128>(...)": [4e-3, 1],
           "dequant_kernel<signed char>": [1e-3, 2], "residual_quant_kernel": [2e-3, 2],
           "elementwise_kernel": [9.0, 9]}
    view = types.SimpleNamespace(mc=TINY_DENSE, counted=[10], dispatched=[10, 20],
                                 window_s=1.0, trace=_trace(ops))
    want = 100 * sum(MATMUL.bound_seconds(TINY_DENSE, s) for s in (10, 20)) / 3e-3
    assert MATMUL.read(view) == pytest.approx(want)
    want = 100 * sum(FLASH.bound_seconds(TINY_DENSE, s) for s in (10, 20)) / 4e-3
    assert FLASH.read(view) == pytest.approx(want)
    assert MFU.read(view) == pytest.approx(100 * MFU.model_flops(TINY_DENSE, 10) / BF16_FLOPS)
    assert IDLE.read(view) == pytest.approx(50.0)
    kv = types.SimpleNamespace(elements=[512, 512], block=256, window_s=1.0, trace=_trace(ops))
    assert DQ.read(kv) == pytest.approx(100 * 4 * 1552 / HBM_BYTES_PER_S / 1e-3)
    assert RQ.read(kv) == pytest.approx(100 * 4 * 1552 / HBM_BYTES_PER_S / 2e-3)


def test_a_kernel_missing_from_the_trace_reads_nothing():
    view = types.SimpleNamespace(mc=TINY_DENSE, counted=[10], dispatched=[10], window_s=1.0,
                                 trace=_trace({"elementwise_kernel": [1.0, 1]}, busy=0.0))
    assert MATMUL.read(view) is None and FLASH.read(view) is None and IDLE.read(view) is None
    untraced = types.SimpleNamespace(mc=TINY_DENSE, counted=[10], dispatched=[10],
                                     window_s=1.0, trace=None)
    assert MATMUL.read(untraced) is None


def test_busy_union_counts_overlaps_once():
    total, merged = busy_union([(0, 2), (1, 3), (5, 6), (5.5, 5.7)])
    assert total == 4 and merged == [(0, 3), (5, 6)]
