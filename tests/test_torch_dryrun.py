"""The port's dry run (``python -m repro_torch.launch.dryrun``) on the CPU.

Each cell runs in a subprocess (a fake world of 256 or 512 ranks is a
process-wide default group), so the pytest worker keeps no process group
and no environment variable (``torch_dist_helpers.dist_guard``).  The
cells: qwen3-0.6b ``train_4k``, ``prefill_32k`` and ``decode_32k`` on the
16x16 mesh, the ``--compressed`` exchange on 2x16x16, llama3-8b
``train_4k``, deepseek-v2-lite-16b's ``train_4k`` cut to 2 layers with and
without ``moe_ep``, and an unknown arch (a ``FAILED__`` file and exit code
1).
Each written cell has the reference's JSON keys.  Every step holds this
rank's ``param_specs`` shards: a cell's ``argument_bytes`` are the local
shards' bytes (and the moments' and step count's in a train cell) plus
the rank's batch or caches.  The qwen3-0.6b train cell's collectives are
the sharded step's: all-gathers, tensor-parallel all-reduces, and
reduce-scatters of exactly 4 bytes an element of each float32 gradient
piece that its leaf's gathers hand back (the pieces of this rank's
``"data"`` shards; ``wk`` and ``wv``, gathered over ``"model"`` too,
first their ``"model"`` pieces; the tied embedding twice, its lookup's and
the logits'); llama3-8b's ``train_4k`` now fits a card (its whole state
took 89 GiB).  The decode cell's arguments hold this rank's pieces of the
caches (``cache_specs``: its rows, S/16 of the sequence), and their
in-place writes are no temporaries.  ``model_flops_total`` equals the
reference's own lines (read from ``repro/launch/dryrun.py``'s source, not
imported), evaluated on the reference's configs, for every arch and cell.
"""
import ast
import dataclasses
import json
import math
import os
import subprocess
import sys

import pytest
import torch
from torch_dist_helpers import ROOT, dist_guard  # noqa: F401

from repro import configs as RC

import repro_torch.configs as PC
from repro_torch.launch.dryrun import model_flops_total
from repro_torch.models import build_model
from repro_torch.models import transformer as T
from repro_torch.parallel.partition import param_specs, shard_shape, spec_axes
from repro_torch.parallel.sharding import P, abstract_mesh, tree_map_with_path
from repro_torch.training.train_step import cache_specs

TIMEOUT = 600
KEYS = {"arch", "shape", "mesh", "compressed", "devices", "kind", "cost", "memory",
        "collectives", "roofline", "tag", "seconds"}
RUNS = {  # name -> dry-run arguments
    "qwen_train": ["--arch", "qwen3-0.6b", "--shape", "train_4k"],
    "qwen_prefill": ["--arch", "qwen3-0.6b", "--shape", "prefill_32k"],
    "qwen_decode": ["--arch", "qwen3-0.6b", "--shape", "decode_32k"],
    "qwen_comp": ["--arch", "qwen3-0.6b", "--shape", "train_4k", "--multi-pod", "--compressed"],
    "llama_train": ["--arch", "llama3-8b", "--shape", "train_4k"],
    # deepseek cut to its dense first layer and one MoE layer, expert
    # parallel (its moe_ep) and on the dense dispatch
    "ep_train": ["--arch", "deepseek-v2-lite-16b", "--shape", "train_4k",
                 "--override", "n_layers=2"],
    "dense_train": ["--arch", "deepseek-v2-lite-16b", "--shape", "train_4k",
                    "--override", "n_layers=2", "--override", "moe_ep=False"],
    "unknown": ["--arch", "no-such-arch", "--shape", "train_4k"],
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run's (exit code, output, written files), all started at once."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {}
    for name, args in RUNS.items():
        out = tmp_path_factory.mktemp(name)
        procs[name] = (out, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *args, "--out", str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    done = {}
    try:
        for name, (out, p) in procs.items():
            log = p.communicate(timeout=TIMEOUT)[0]
            done[name] = (p.returncode, log, {f.name: f for f in out.iterdir()})
    finally:
        for _, p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return done


def _cell(runs, name) -> dict:
    rc, log, files = runs[name]
    assert rc == 0, log
    (path,) = files.values()
    assert not path.name.startswith("FAILED__")
    return json.loads(path.read_text())


@pytest.mark.parametrize("name,kind", [("qwen_train", "train"), ("qwen_prefill", "prefill"),
                                       ("qwen_decode", "decode")])
def test_cells_write_the_reference_keys(runs, name, kind):
    cell = _cell(runs, name)
    assert KEYS <= set(cell)
    assert (cell["mesh"], cell["devices"], cell["kind"], cell["compressed"]) == \
        ("16x16", 256, kind, False)
    assert set(cell["seconds"]) == {"trace"}
    assert cell["cost"]["flops_per_device"] > 0 and cell["cost"]["bytes_per_device"] > 0
    assert set(cell["memory"]) >= {"argument_bytes", "temp_bytes", "fits", "arguments_fit"}
    r = cell["roofline"]
    assert r["dominant"] in ("compute", "memory", "collective")
    assert r["compute_s"] == cell["cost"]["flops_per_device"] / 989e12
    assert r["memory_s"] == cell["cost"]["bytes_per_device"] / 3.35e12
    assert cell["memory"]["arguments_fit"] is True  # qwen3-0.6b's state fits a card
    if kind != "decode":  # the flash kernel's counted work
        assert cell["cost"]["kernels"]["flash_attention"]["calls"] > 0


def _reduce_scatter_elements(params, cfg, mesh) -> int:
    """The float32 elements that a sharded qwen3-0.6b train step's
    reduce-scatters hand back on 16x16: each leaf split over ``"data"``
    once its local shard (a stacked leaf's layers together), ``wk`` and
    ``wv`` first their ``"model"`` pieces (16 x the shard: the 8 kv heads
    do not divide the axis, so the blocks gather them whole), the tied
    embedding twice (its lookup and the logits each gather it)."""
    specs = param_specs(params, cfg, mesh)
    found = []
    tree_map_with_path(lambda path, leaf: found.append((path, leaf)), params)
    total = 0
    for (path, leaf), spec in zip(found, _leaves(specs), strict=True):
        if "data" not in spec_axes(spec):
            continue
        local = math.prod(shard_shape(leaf.shape, spec, mesh))
        total += local * {"wk": 17, "wv": 17, "embed": 2}.get(path[-1], 1)
    return total


def test_train_cell_counts_the_one_flat_all_reduce(runs):
    """The sharded step's collectives: the gathers, the tensor-parallel and
    flat all-reduces, and the gradients' reduce-scatters exactly."""
    cell = _cell(runs, "qwen_train")
    cfg = PC.get_config("qwen3-0.6b")
    mesh = abstract_mesh((16, 16), ("data", "model"))
    by_type = cell["collectives"]["by_type"]
    assert set(by_type) == {"all-gather", "all-reduce", "reduce-scatter"}
    assert cell["collectives"]["total_bytes"] == sum(by_type.values())
    assert by_type["reduce-scatter"] == 4 * _reduce_scatter_elements(
        build_model(cfg).init_shapes(), cfg, mesh)
    assert cell["batch_rows_per_device"] == 256 // 16
    assert cell["cost"]["kernels"]["flash_attention_bwd"]["calls"] == 28  # one a layer


def _leaves(tree):
    if isinstance(tree, P):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree) for x in _leaves(getattr(tree, f.name))]
    return [] if tree is None else [tree]


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _shard_bytes(cfg, mesh, moments: bool = False) -> int:
    """The bytes of this rank's ``param_specs`` shards of the params (and of
    the two float32 AdamW moments and the int32 step count)."""
    params = build_model(cfg).init_shapes()
    total = 4 if moments else 0
    for leaf, spec in zip(_leaves(params), _leaves(param_specs(params, cfg, mesh)), strict=True):
        n = math.prod(shard_shape(leaf.shape, spec, mesh))
        total += n * (leaf.element_size() + (8 if moments else 0))
    return total


def test_compressed_cell(runs):
    cell = _cell(runs, "qwen_comp")
    assert (cell["mesh"], cell["devices"], cell["compressed"]) == ("2x16x16", 512, True)
    ex = cell["exchange"]
    assert set(ex) == {"compressed", "plain_psum"}
    assert 0 < ex["compressed"]["collective_bytes"] < ex["plain_psum"]["collective_bytes"]
    assert set(ex["plain_psum"]["by_type"]) == {"all-reduce"}
    assert ex["compressed"]["kernels"]["base_fit"]["calls"] > 0
    wire = cell["analytic_wire"]
    assert wire["ratio"] == wire["f32_bytes"] / wire["compressed_bytes"] > 3


def test_decode_cell_counts_the_caches_as_arguments(runs):
    """A decode cell's arguments are this rank's shards of the params, its
    rows of the tokens, the cache index and its pieces of the caches under
    ``cache_specs``: its 8 of the 128 rows and 2048 of the 32768 positions,
    a 256th of the whole; the caches' in-place writes are not
    temporaries."""
    cell = _cell(runs, "qwen_decode")
    m = build_model(PC.get_config("qwen3-0.6b"))
    shape = PC.SHAPES["decode_32k"]
    rows = cell["batch_rows_per_device"]
    assert rows == shape.global_batch // 16
    caches = T.make_decode_caches(m.cfg, shape.global_batch, shape.seq_len, 0,
                                  torch.device("meta"))
    mesh = abstract_mesh((16, 16), ("data", "model"))
    specs = cache_specs(caches, mesh, "data")
    pieces = sum(math.prod(shard_shape(c.shape, s, mesh)) * c.element_size()
                 for c, s in zip(_leaves(caches), _leaves(specs), strict=True))
    assert pieces == _bytes(caches) // 256 and pieces > 2**30
    assert cell["memory"]["argument_bytes"] == _shard_bytes(m.cfg, mesh) + pieces \
        + rows * 4 + 4
    assert 0 < cell["memory"]["temp_bytes"] < pieces // 10  # one layer's scratch, no cache


def test_llama3_8b_train_does_not_fit_a_card(runs):
    """llama3-8b's whole state (89 GiB) does not fit a card; the sharded
    step's arguments are this rank's shards of it and its 16 rows of
    tokens and labels, and the cell fits."""
    cell = _cell(runs, "llama_train")
    cfg = PC.get_config("llama3-8b")
    mesh = abstract_mesh((16, 16), ("data", "model"))
    whole = cfg.param_count() * (2 * 2 + 8)  # params, gradients, two float32 moments
    assert whole > 80 * 1024**3
    rows = cell["batch_rows_per_device"]
    assert cell["memory"]["argument_bytes"] == _shard_bytes(cfg, mesh, moments=True) \
        + 2 * rows * 4096 * 4
    assert cell["memory"]["argument_bytes"] < 2**30
    assert cell["memory"]["fits"] is True
    assert cell["memory"]["argument_bytes"] + cell["memory"]["temp_bytes"] <= 80 * 1024**3


def test_moe_ep_train_cell_runs_expert_parallel(runs):
    """A ``moe_ep`` train cell trains its experts expert parallel (no
    "moe_ep off" note: the reference's cells carry no notes): each rank
    gathers only its 4 of the 64 experts, so the gradients' reduce-scatters
    hand back exactly 15 x its expert shards' float32 bytes fewer than the
    dense dispatch's (which gathers all 64 over "model" and scatters their
    gradients over "data"), and the peak falls."""
    ep, dense = _cell(runs, "ep_train"), _cell(runs, "dense_train")
    assert "notes" not in ep and KEYS <= set(ep)
    cfg = PC.get_config("deepseek-v2-lite-16b")
    mesh = abstract_mesh((16, 16), ("data", "model"))
    params = build_model(dataclasses.replace(cfg, n_layers=2)).init_shapes()
    specs = param_specs(params, cfg, mesh)
    moe = params["groups"]["pos0"]["moe"]
    shard = sum(math.prod(shard_shape(moe[k].shape, specs["groups"]["pos0"]["moe"][k], mesh))
                for k in ("wg", "wu", "wd"))
    scatter = {n: c["collectives"]["by_type"]["reduce-scatter"]
               for n, c in (("ep", ep), ("dense", dense))}
    assert scatter["dense"] - scatter["ep"] == 15 * 4 * shard
    gather = {n: c["collectives"]["by_type"]["all-gather"] for n, c in (("ep", ep),
                                                                         ("dense", dense))}
    assert gather["ep"] * 10 < gather["dense"]
    assert ep["memory"]["temp_bytes"] < dense["memory"]["temp_bytes"]


def test_a_failed_cell_writes_its_traceback(runs):
    rc, log, files = runs["unknown"]
    assert rc == 1
    assert list(files) == ["FAILED__no-such-arch__train_4k__16x16.txt"]
    assert "no-such-arch" in files["FAILED__no-such-arch__train_4k__16x16.txt"].read_text()


def _reference_flops_lines():
    """The lines of ``repro.launch.dryrun.run_cell`` that compute
    ``model_flops_total`` (from ``mult = ...`` through the if/else after
    it), read from its source and compiled here: importing that module
    sets XLA_FLAGS."""
    path = ROOT / "src" / "repro" / "launch" / "dryrun.py"
    tree = ast.parse(path.read_text())
    (fn,) = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "run_cell"]
    (i,) = [i for i, st in enumerate(fn.body) if isinstance(st, ast.Assign)
            and [t.id for t in st.targets if isinstance(t, ast.Name)] == ["mult"]]
    lines = fn.body[i:i + 2]
    assert isinstance(lines[1], ast.If) and "model_flops_total" in ast.unparse(lines[1])
    return compile(ast.Module(body=lines, type_ignores=[]), str(path), "exec")


REFERENCE_FLOPS = _reference_flops_lines()


def _reference_model_flops(cfg, shape) -> int:
    scope = {"cfg": cfg, "shape": shape}
    exec(REFERENCE_FLOPS, scope)
    return scope["model_flops_total"]


@pytest.mark.parametrize("arch", sorted(RC.ARCHS))
def test_model_flops_total_is_the_reference_formula(arch):
    for shape in RC.cells_for(RC.get_config(arch)):
        assert model_flops_total(PC.get_config(arch), PC.SHAPES[shape]) == \
            _reference_model_flops(RC.get_config(arch), RC.SHAPES[shape])
