"""The port's SHRINK gradient exchange (``repro_torch.training.grad_compress``)
against the reference's, on the CPU.

* A world of one (no process group) against ``make_crosspod_exchange`` on
  the (1, 1, 1) mesh, as ``tests/test_grad_compress.py`` builds it: bits 8
  and 4, leaves whose size is not a multiple of the block, leaves under
  ``min_leaf_size`` (the plain mean).
* Two processes on gloo (a ``file://`` rendezvous in the test's own
  directory, so parallel workers never share a port) against
  ``emulated_exchange`` of ``examples/train_multipod_compressed.py``, the
  reference's single-device emulation of two pods, jitted as the example
  runs it.
* ``compression_wire_bytes`` equal.

Tolerance: the mean gradient and the new error feedback within 2.5e-7 of
the leaf's largest |mean| (two float32 ulps at that scale; measured at
most 1.02e-7).  The fit is the ``base_fit`` kernel's plain version (the
reference's eager summation order), the step and the quantizer divide as
the reference does, the two dequantizations round once as XLA's fused
multiply-adds do, and the pod sums of two terms have one order; but the
reference runs jitted, and XLA then sums the fit's dot over many rows, and
the 4-bit path's dequantization, in orders of its own.  Where it does not
(8 bits, up to 4 blocks), the results equal bit for bit.
"""
import importlib.util
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.training import grad_compress as RG

from repro_torch.training import grad_compress as PG
from repro_torch.training._tree import leaves

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPES = {"w": (300, 77), "b": (1000,), "s": (5, 3)}


def _grads(seed, pods=None):
    rng = np.random.default_rng(seed)
    lead = () if pods is None else (pods,)
    return {k: (rng.standard_normal(lead + s) * 0.01).astype(np.float32)
            for k, s in SHAPES.items()}


def _ef(seed):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * 1e-4).astype(np.float32) for k, s in SHAPES.items()}


REL = 2.5e-7


def _close(got, want, scale, exact: bool):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=REL * np.abs(scale).max())


def _same(mean, ef, want, want_ef, bits):
    for k in SHAPES:
        exact = bits == 8 and k == "b"  # 4 blocks of 256
        _close(mean[k], want[k], want[k], exact)
        _close(ef[k], want_ef[k], want[k], exact)


@pytest.mark.parametrize("bits,min_leaf", [(8, 0), (4, 0), (8, 2000), (4, 2000)])
def test_world_of_one_matches_crosspod_exchange(bits, min_leaf):
    g, ef = _grads(0), _ef(1)
    rcfg = RG.GradCompressConfig(bits=bits, min_leaf_size=min_leaf)
    pcfg = PG.GradCompressConfig(bits=bits, min_leaf_size=min_leaf)
    mesh = jax.make_mesh((1, 1, 1), ("pod", "data", "model"))
    spec = {k: P(*([None] * len(s))) for k, s in SHAPES.items()}
    want, want_ef = jax.jit(RG.make_crosspod_exchange(mesh, rcfg, spec))(
        {k: jnp.asarray(v)[None] for k, v in g.items()}, jax.tree.map(jnp.asarray, ef))
    t = lambda tree: {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
    got, got_ef = PG.compressed_psum_tree(t(g), t(ef), pcfg)
    _same(got, got_ef, want, want_ef, bits)


def test_wire_bytes_match_reference():
    for cfg in (dict(), dict(block=128, bits=4, min_leaf_size=1000)):
        params = {k: np.zeros(s, np.float32) for k, s in SHAPES.items()}
        want = RG.compression_wire_bytes(jax.tree.map(jnp.asarray, params),
                                         RG.GradCompressConfig(**cfg))
        got = PG.compression_wire_bytes({k: torch.from_numpy(v) for k, v in params.items()},
                                        PG.GradCompressConfig(**cfg))
        assert got == want


_WORKER = r"""
import sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.training.grad_compress import GradCompressConfig, compressed_psum_tree
d, rank, bits = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
dist.init_process_group("gloo", init_method=f"file://{d}/rendezvous", rank=rank, world_size=2)
inp = np.load(f"{d}/in.npz")
names = sorted({k.split(":")[1] for k in inp.files})
g = {k: torch.from_numpy(inp[f"g:{k}"][rank].copy()) for k in names}
ef = {k: torch.from_numpy(inp[f"e:{k}"].copy()) for k in names}
mean, new_ef = compressed_psum_tree(g, ef, GradCompressConfig(bits=bits, min_leaf_size=0))
np.savez(f"{d}/out{rank}.npz", **{f"g:{k}": mean[k].numpy() for k in names},
         **{f"e:{k}": new_ef[k].numpy() for k in names})
dist.destroy_process_group()
"""


def _emulated():
    spec = importlib.util.spec_from_file_location(
        "mp_example", ROOT / "examples" / "train_multipod_compressed.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.emulated_exchange


@pytest.mark.parametrize("bits", [8, 4])
def test_two_gloo_pods_match_emulated_exchange(bits, tmp_path):
    g, ef = _grads(2, pods=2), _ef(3)
    np.savez(tmp_path / "in.npz", **{f"g:{k}": v for k, v in g.items()},
             **{f"e:{k}": v for k, v in ef.items()})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(tmp_path), str(r), str(bits)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = [p.communicate(timeout=120)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs
    exchange = jax.jit(lambda a, e: _emulated()(
        a, e, RG.GradCompressConfig(bits=bits, min_leaf_size=0)))  # as the example runs it
    want, want_ef = exchange(jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, ef))
    outs = [np.load(tmp_path / f"out{r}.npz") for r in range(2)]
    for k in SHAPES:  # every pod holds the same mean
        np.testing.assert_array_equal(outs[1][f"g:{k}"], outs[0][f"g:{k}"])
    _same({k: outs[0][f"g:{k}"] for k in SHAPES}, {k: outs[0][f"e:{k}"] for k in SHAPES},
          want, want_ef, bits)
