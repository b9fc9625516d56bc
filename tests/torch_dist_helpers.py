"""Shared helpers of the port's parallel tests (``tests/test_torch_{sharding,
partition,mesh,moe_ep,crosspod}.py``).

No test leaves process-global state behind in the pytest worker, which
runs many files in turn:

* ``dist_guard`` (module-scoped, autouse where imported) asserts at the
  module's teardown that no default process group is left and that
  ``os.environ`` is as it was at the module's setup (but for pytest's own
  ``PYTEST_CURRENT_TEST``);
* ``one_rank`` makes a one-rank gloo group on a ``FileStore`` in the
  test's own directory (no port, no environment variable) and destroys it
  at teardown; meshes come from ``init_device_mesh("cpu", ...)`` on it;
* ``run_ranks`` runs a multi-rank check as subprocesses on gloo, with a
  ``file://`` rendezvous under the test's directory, each with a timeout;
  the worker script destroys its group in a ``finally``.

The sharded steps return DTensors of each rank's shards; ``whole``,
``whole_grads``, ``placed_as_specs`` and ``recording_update`` read them
back whole on every rank.

torch's first DTensor call imports ``torch._dynamo``, which sets
``TORCHINDUCTOR_CACHE_DIR`` to its default once a process; importing it
here makes that happen while the tests are collected, before any guard's
setup, so the guard holds the tests themselves to the environment.
"""
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch._dynamo  # noqa: F401  (see the module docstring)
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.parallel import param_specs
from repro_torch.parallel.collectives import step_specs
from repro_torch.parallel.sharding import spec_placements
from repro_torch.training import train_step as TS
from repro_torch.training._tree import leaves

ROOT = pathlib.Path(__file__).resolve().parents[1]
RANK_TIMEOUT = 240  # seconds a worker may take

# the worker's preamble: argv is (directory, rank, world); the check's own
# code follows and may use d, rank, world; the group is destroyed after it
_PREAMBLE = """
import sys
import numpy as np, torch, torch.distributed as dist
d, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
dist.init_process_group("gloo", init_method=f"file://{d}/rendezvous", rank=rank,
                        world_size=world)
try:
{body}
finally:
    dist.destroy_process_group()
"""


@pytest.fixture(scope="module", autouse=True)
def dist_guard():
    env = dict(os.environ)
    yield
    assert not dist.is_initialized(), "a test left a default process group behind"
    changed = {k for k in set(env) | set(os.environ)
               if env.get(k) != os.environ.get(k) and k != "PYTEST_CURRENT_TEST"}
    assert not changed, f"a test changed os.environ: {sorted(changed)}"


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo world for the test's in-process meshes."""
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_ranks(body: str, world: int, directory: pathlib.Path,
              timeout: float = RANK_TIMEOUT) -> None:
    """Run ``body`` (Python source) on ``world`` gloo ranks in
    subprocesses; every rank must exit 0 within ``timeout`` seconds (a
    rank that waits on a collective that another never makes is killed
    there)."""
    script = _PREAMBLE.replace("{body}", textwrap.indent(textwrap.dedent(body), "    "))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]))
    procs = [subprocess.Popen([sys.executable, "-c", script, str(directory), str(r), str(world)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)


def whole(tree) -> list:
    """A step's output leaves, each DTensor gathered whole (a collective)."""
    return [t.full_tensor() if isinstance(t, DTensor) else t for t in leaves(tree)]


def placed_as_specs(model, params, mesh, tree) -> bool:
    """Whether each leaf of ``tree`` (params of ``params``' structure) is a
    DTensor on ``mesh`` with its spec's placements."""
    specs = leaves(param_specs(params, model.cfg, mesh))
    return all(isinstance(t, DTensor) and t.placements == spec_placements(mesh, s)
               for t, s in zip(leaves(tree), specs, strict=True))


def whole_grads(model, params, mesh, local: list) -> list:
    """Gradients recorded as this rank's shards (placed by the step's
    ``step_specs``), made whole over ``mesh``."""
    specs = leaves(step_specs(params, model.cfg, mesh))
    return [DTensor.from_local(g, mesh, spec_placements(mesh, s), run_check=False,
                               shape=p.shape, stride=p.stride()).full_tensor()
            for g, s, p in zip(local, specs, leaves(params), strict=True)]


def recording_update(seen: list):
    """``train_step._update`` wrapped so that each step's gradient, averaged
    over the ranks and not yet clipped, is appended to ``seen`` (a sharded
    step's: this rank's shards)."""
    update = TS._update

    def record(opt_cfg, params, opt_state, grads, **kw):
        seen.append([g.detach().clone() for g in leaves(grads)])
        return update(opt_cfg, params, opt_state, grads, **kw)

    return record
