"""The port's dry run (``python -m repro_torch.launch.dryrun``) on the CPU.

Each cell runs in a subprocess (a fake world of 256 or 512 ranks is a
process-wide default group), so the pytest worker keeps no process group
and no environment variable (``torch_dist_helpers.dist_guard``).  The
cells: qwen3-0.6b ``train_4k``, ``prefill_32k`` and ``decode_32k`` on the
16x16 mesh, the ``--compressed`` exchange on 2x16x16, llama3-8b
``train_4k`` (whose state and step do not fit one 80 GiB card), and an
unknown arch (a ``FAILED__`` file and exit code 1).  Each written cell has
the reference's JSON keys; the train cell's collective bytes are exactly
2 x 4 bytes x the elements of the one float32 buffer its data-parallel
all-reduce carries (every parameter's gradient and the four metrics); the
decode cell's arguments hold the caches, and their in-place writes are no
temporaries.  ``model_flops_total`` equals the reference's own lines
(read from ``repro/launch/dryrun.py``'s source, not imported), evaluated
on the reference's configs, for every arch and cell.
"""
import ast
import dataclasses
import json
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

TIMEOUT = 600
KEYS = {"arch", "shape", "mesh", "compressed", "devices", "kind", "cost", "memory",
        "collectives", "roofline", "tag", "seconds"}
RUNS = {  # name -> dry-run arguments
    "qwen_train": ["--arch", "qwen3-0.6b", "--shape", "train_4k"],
    "qwen_prefill": ["--arch", "qwen3-0.6b", "--shape", "prefill_32k"],
    "qwen_decode": ["--arch", "qwen3-0.6b", "--shape", "decode_32k"],
    "qwen_comp": ["--arch", "qwen3-0.6b", "--shape", "train_4k", "--multi-pod", "--compressed"],
    "llama_train": ["--arch", "llama3-8b", "--shape", "train_4k"],
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


def test_train_cell_counts_the_one_flat_all_reduce(runs):
    cell = _cell(runs, "qwen_train")
    params = build_model(PC.get_config("qwen3-0.6b")).init_shapes()
    n = sum(p.numel() for p in _leaves(params))
    assert cell["collectives"] == {"total_bytes": 2 * 4 * (n + 4),
                                   "by_type": {"all-reduce": 2 * 4 * (n + 4)}}
    assert cell["batch_rows_per_device"] == 256 // 16
    assert cell["cost"]["kernels"]["flash_attention_bwd"]["calls"] == 28  # one a layer


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree) for x in _leaves(getattr(tree, f.name))]
    return [] if tree is None else [tree]


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


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
    """A decode cell's arguments are the params, this rank's tokens, the
    cache index and the caches of the whole sequence; the caches' in-place
    writes are not temporaries."""
    cell = _cell(runs, "qwen_decode")
    m = build_model(PC.get_config("qwen3-0.6b"))
    rows = cell["batch_rows_per_device"]
    caches = T.make_decode_caches(m.cfg, rows, PC.SHAPES["decode_32k"].seq_len, 0,
                                  torch.device("meta"))
    cache_bytes = _bytes(caches)
    assert cache_bytes > 2**30
    assert cell["memory"]["argument_bytes"] == _bytes(m.init_shapes()) + cache_bytes + rows * 4 + 4
    assert 0 < cell["memory"]["temp_bytes"] < cache_bytes // 10  # one layer's scratch, no cache


def test_llama3_8b_train_does_not_fit_a_card(runs):
    cell = _cell(runs, "llama_train")
    assert cell["memory"]["fits"] is False
    assert cell["memory"]["argument_bytes"] + cell["memory"]["temp_bytes"] > 80 * 1024**3


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
