"""The harness finds each configuration, mix, runner, limit and per-layer
metric by its name, and ``BENCHMARK.json`` keeps to its schema and limits."""
from __future__ import annotations

import json
import re

import pytest

from harness import common

BENCH = common.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_budget():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits: 2 + 14 x 24 runs, each run_seconds + 60 s,
    # 2 x 90 s of compile a cell, 1200 s spare, in 43200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_keys():
    seen = set()
    for table, keys in (("configs", {"name", "source", "file", "reduced", "why"}),
                        ("workloads", {"name", "config", "traffic", "chips", "why"})):
        for entry in BENCH[table]:
            assert set(entry) == keys
            assert NAME.match(entry["name"]) and entry["name"] not in seen
            seen.add(entry["name"])
            assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    for table in ("end_to_end", "per_layer"):
        for m in BENCH[table]:
            assert NAME.match(m["name"]) and m["name"] not in seen
            seen.add(m["name"])
            assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_every_cell_finds_its_files():
    names = {c["name"] for c in BENCH["configs"]}
    for cell in BENCH["workloads"]:
        assert cell["config"] in names and cell["chips"] in (1, 4)
        cfg = common.read_json(common.config_file(cell["config"]))
        mix = common.read_json(common.traffic_file(cell["traffic"]))
        common.load_module("runners", mix["runner"]).run  # noqa: B018
        assert common.read_json(common.limits_file(cell["name"]))
        assert cfg["model_config"]
        e2e = common.cell_metrics(BENCH, cell["name"], "end_to_end")
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        per_layer = common.cell_metrics(BENCH, cell["name"], "per_layer")
        assert per_layer
        for m in per_layer:
            assert callable(common.load_module("metrics", m["name"]).read)


def test_config_files_hold_their_entry():
    for entry in BENCH["configs"]:
        cfg = common.read_json(common.ROOT / entry["file"])
        assert entry["file"] == f"perfbench/configs/{entry['name']}.json"
        assert cfg["source"] == entry["source"] and cfg["reduced"] == entry["reduced"]
        mc = cfg["model_config"]
        assert mc["name"] == entry["name"]
        # the port's config is the published one, key by key
        assert (mc["n_layers"], mc["d_model"], mc["n_heads"], mc["vocab_size"]) == (
            cfg["num_hidden_layers"], cfg["hidden_size"], cfg["num_attention_heads"],
            cfg["vocab_size"])
        assert mc["n_kv_heads"] == cfg["num_key_value_heads"]
        assert mc["d_ff"] == cfg["intermediate_size"]
        assert mc["norm_eps"] == cfg["rms_norm_eps"]
        assert mc["rope_theta"] == cfg["rope_theta"]
        assert mc["tie_embeddings"] == cfg["tie_word_embeddings"]
        if "head_dim" in cfg:
            assert mc["head_dim"] == cfg["head_dim"]
        if "n_routed_experts" in cfg:
            assert (mc["n_experts"], mc["top_k"], mc["moe_d_ff"], mc["n_shared_experts"],
                    mc["first_dense_layers"], mc["kv_lora_rank"], mc["qk_nope_head_dim"],
                    mc["qk_rope_head_dim"], mc["v_head_dim"]) == (
                cfg["n_routed_experts"], cfg["num_experts_per_tok"],
                cfg["moe_intermediate_size"], cfg["n_shared_experts"],
                cfg["first_k_dense_replace"], cfg["kv_lora_rank"], cfg["qk_nope_head_dim"],
                cfg["qk_rope_head_dim"], cfg["v_head_dim"])
        assert all(key in cfg for key in cfg["reduced"])


def test_a_new_config_mix_and_metric_are_found_by_name(tmp_path, monkeypatch):
    for sub in ("configs", "traffic", "metrics", "runners", "limits"):
        (tmp_path / sub).mkdir()
    (tmp_path / "configs" / "dummy-model.json").write_text('{"model_config": {"d_model": 8}}')
    (tmp_path / "traffic" / "dummy-mix.json").write_text('{"runner": "dummy_runner"}')
    (tmp_path / "limits" / "dummy-model.dummy-mix.json").write_text('{"x": 1.0}')
    (tmp_path / "runners" / "dummy_runner.py").write_text("def run(job):\n    return 'ran'\n")
    (tmp_path / "metrics" / "dummy_count.layer.py").write_text(
        "def read(view):\n    return 2.0 * view\n")
    monkeypatch.setattr(common, "BENCH_DIR", tmp_path)
    assert common.read_json(common.config_file("dummy-model"))["model_config"]["d_model"] == 8
    mix = common.read_json(common.traffic_file("dummy-mix"))
    assert common.load_module("runners", mix["runner"]).run(None) == "ran"
    assert common.load_module("metrics", "dummy_count.layer").read(21.0) == 42.0
    assert common.read_json(common.limits_file("dummy-model.dummy-mix")) == {"x": 1.0}
    with pytest.raises(common.BenchError):
        common.load_module("metrics", "not_there")
    bench = {"end_to_end": [{"name": "a_s", "workloads": ["c1"]}, {"name": "setup_s"}],
             "per_layer": [{"name": "dummy_count.layer", "moves": "a_s"},
                           {"name": "other", "moves": "setup_s", "workloads": ["c2"]}]}
    assert [m["name"] for m in common.cell_metrics(bench, "c1", "per_layer")] == [
        "dummy_count.layer"]
    assert [m["name"] for m in common.cell_metrics(bench, "c2", "end_to_end")] == ["setup_s"]


def test_seeds_are_large_and_stable():
    big = 2**31 + 5
    assert common.derive_seed(big, "weights") == common.derive_seed(big, "weights")
    assert common.derive_seed(big, "weights") != common.derive_seed(big + 1, "weights")
    assert 0 <= common.derive_seed(big, "tokens", 3) < 2**63
