"""Each mix is deterministic for a seed; seeds change the order and the
data, never the multiset of lengths."""
from __future__ import annotations

import pytest
import torch

from harness import common, traffic


def _mix(name: str) -> dict:
    return common.read_json(common.traffic_file(name))


def test_prefill_lengths_are_a_fixed_multiset():
    spec = _mix("prefill-long")["prompt_lengths"]
    a = traffic.lengths(spec)
    assert a == traffic.lengths(spec) and len(a) == spec["count"]
    assert spec["min"] <= min(a) and max(a) <= spec["max"]
    assert sorted(a)[len(a) // 2 - 1] <= spec["median"] <= sorted(a)[len(a) // 2]


def test_prefill_lengths_average_their_sources_mean():
    mix = _mix("prefill-long")
    a = traffic.lengths(mix["prompt_lengths"])
    assert abs(sum(a) / len(a) - mix["mean_tokens"]) < 0.01 * mix["mean_tokens"]


def test_kv_sessions_reach_the_pool_size():
    spec = _mix("kv-park")["session_lengths"]
    a = traffic.lengths(spec)
    assert sum(a) >= spec["total_tokens"] > sum(traffic.lengths({**spec, "count": len(a) - 1}))
    assert spec["min"] <= min(a) and max(a) <= spec["max"]


def test_order_is_seeded_and_each_item_comes_once_a_sweep():
    s1, s2 = traffic.Schedule(32, 2**31 + 1), traffic.Schedule(32, 2**31 + 1)
    first = [s1.next()[1] for _ in range(96)]
    assert first == [s2.next()[1] for _ in range(96)]
    for k in range(3):
        assert sorted(first[32 * k:32 * k + 32]) == list(range(32))
    assert first[:32] != first[32:64]
    other = traffic.Schedule(32, 2**31 + 2)
    assert [other.next()[1] for _ in range(32)] != first[:32]


def test_prompt_tokens_are_deterministic():
    a = traffic.prompt_tokens(3_000_000_001, 5, 40, 512, "cpu")
    assert a.shape == (1, 40) and a.dtype == torch.int32
    assert torch.equal(a, traffic.prompt_tokens(3_000_000_001, 5, 40, 512, "cpu"))
    assert not torch.equal(a, traffic.prompt_tokens(3_000_000_001, 6, 40, 512, "cpu"))
    assert int(a.min()) >= 0 and int(a.max()) < 512


def test_kv_caches_are_deterministic_and_k_spreads_wider():
    spec = _mix("kv-park")["cache"]
    k, v = traffic.kv_cache(2**31 + 9, 3, 64, 2, 2, 128, spec, "cpu")
    k2, v2 = traffic.kv_cache(2**31 + 9, 3, 64, 2, 2, 128, spec, "cpu")
    assert k.shape == (2, 1, 64, 2, 128) and k.dtype == torch.bfloat16
    assert torch.equal(k, k2) and torch.equal(v, v2)
    ks = k.float().std(dim=(0, 1, 2))  # per (head, channel)
    vs = v.float().std(dim=(0, 1, 2))
    assert ks.log().std() > vs.log().std()
