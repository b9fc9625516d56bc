"""Paths, seeds and the lookup of files by name."""
from __future__ import annotations

import hashlib
import importlib.util
import json
import pathlib
import re
import sys

BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
# the top-level module names that no benchmark process may hold (compared whole:
# the port, ``repro_torch``, begins with ``repro``)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


class BenchError(RuntimeError):
    """The benchmark cannot run here or was asked for something it lacks."""


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is a forbidden one, whole."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def derive_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one stream of the run (weights, a request's tokens,
    an order), the same for the same ``seed`` and tags on every machine."""
    text = ":".join(str(t) for t in (int(seed), *tags))
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "little") >> 1


def check_name(name: str) -> str:
    if not _NAME.match(name):
        raise BenchError(f"not a name the benchmark takes: {name!r}")
    return name


def read_json(path: pathlib.Path) -> dict:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError:
        raise BenchError(f"missing file: {path}") from None


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    return read_json(root / "BENCHMARK.json")


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise BenchError(f"no workload {name!r} in BENCHMARK.json")


def config_file(name: str) -> pathlib.Path:
    return BENCH_DIR / "configs" / f"{check_name(name)}.json"


def traffic_file(name: str) -> pathlib.Path:
    return BENCH_DIR / "traffic" / f"{check_name(name)}.json"


def limits_file(cell: str) -> pathlib.Path:
    return BENCH_DIR / "limits" / f"{check_name(cell)}.json"


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark's folder as a module (a
    metric's name may hold dots, so it is loaded by path)."""
    path = BENCH_DIR / kind / f"{check_name(name)}.py"
    if not path.is_file():
        raise BenchError(f"missing file: {path}")
    spec = importlib.util.spec_from_file_location(f"perfbench_{kind}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # dataclasses look their module up by name
    spec.loader.exec_module(module)
    return module


def cell_metrics(bench: dict, cell: str, table: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that ``cell`` reports: a
    metric with a ``workloads`` list names its cells; a per-layer metric
    without one goes where its ``moves`` metric is reported."""
    e2e = {m["name"]: m for m in bench["end_to_end"]}

    def reports(m: dict) -> bool:
        if "workloads" in m:
            return cell in m["workloads"]
        if table == "per_layer":
            return reports(e2e[m["moves"]])
        return True

    return [m for m in bench[table] if reports(m)]
