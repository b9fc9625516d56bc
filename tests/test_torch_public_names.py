"""Every public name of a reference package whose port is marked done
exists in the port, with the reference's public methods and parameters,
and the names repaired here hold the reference's outputs bit for bit
(float64 and int64, as the codec does).

A package's public names are its ``__all__`` where it has one, else every
name without a leading underscore that is not a submodule.  The waivers
below are the only names allowed to be missing, each with the reason.

For every public function, and every public method (and ``__init__``) of
every public class, the reference's parameters must open the port's, with
the same names, kinds and positions, so a reference call binds the same
arguments in the port; the port may add parameters with defaults after
them.  Methods keep the reference's kind (function, property, static or
class method).  Waived: the route switches the port's rules forbid
(``force_ref``, ``route``, ``block_t``, ``use_kernel``).

``repro.launch.hlo_analysis`` has no port of that name: it parses XLA's
compiled HLO, which an eager PyTorch step does not have.  Its counterpart
is ``repro_torch.launch.cost_analysis``, which counts the ops, kernels and
collectives a step dispatches (``tests/test_torch_cost_analysis.py``).
Importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` (512 host devices) for
the process; :func:`_reference` puts the variable back at once, before
any JAX backend starts.
"""
import dataclasses
import importlib
import inspect
import os
import types

import numpy as np
import pytest
import torch

import repro.core as R

import repro_torch.core as P
from repro_torch.kernels import ops

PORTED = ["core", "analytics", "serving", "models", "configs", "kernels.ops", "data", "testing",
          "parallel", "parallel.sharding", "parallel.partition", "launch.mesh",
          "training", "training.optimizer", "training.train_step",
          "training.grad_compress", "training.checkpoint", "training.fault_tolerance",
          "training.metrics", "data.pipeline", "baselines", "launch.dryrun"]

WAIVERS = {
    "core": {
        # the TPU cone scan's Pallas entry; the port's batch scan is the kernel route
        "extract_semantics_batch_pallas": "Pallas only (the cone scan is csrc/cone_scan.cu)",
    },
    "kernels.ops": {
        "use_interpret": "Pallas interpret mode has no CUDA counterpart",
    },
    # the reference's dry run imports these for its jit shardings and its HLO
    "launch.dryrun": {
        "NamedSharding": "JAX's jit input sharding: the port's steps take each rank's slice",
        "P": "JAX's PartitionSpec for the jit shardings (the port's is parallel.sharding.P)",
        "batch_specs": "jit input shardings: a port step slices its own batch",
        "cache_specs": "jit input shardings: a port decode step takes this rank's caches",
        "analyze_hlo": "XLA HLO only: the port counts with launch.cost_analysis.analyze_step",
        "compiled_cost_dict": "XLA's compiled cost analysis: no compiled step in the port",
        "AdamWConfig": "imported and unused by the reference's dry run",
        "make_compressed_train_step": "imported and unused by the reference's dry run",
    },
}


ROUTE_SWITCHES = {"force_ref", "route", "block_t", "use_kernel"}


def _reference(pkg: str):
    """The reference module ``repro.<pkg>``, with ``XLA_FLAGS`` as it was
    before the import (``repro.launch.dryrun`` sets it when imported)."""
    flags = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(f"repro.{pkg}")
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags


def _public(mod) -> list[str]:
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in dir(mod) if not n.startswith("_")
                 and not isinstance(getattr(mod, n), types.ModuleType)]
    return sorted(names)


@pytest.mark.parametrize("pkg", PORTED)
def test_every_reference_name_exists_in_the_port(pkg):
    ref = _reference(pkg)
    port = importlib.import_module(f"repro_torch.{pkg}")
    waived = WAIVERS.get(pkg, {})
    missing = [n for n in _public(ref) if not hasattr(port, n) and n not in waived]
    assert missing == []
    # a waiver names a name the reference has and the port still lacks
    assert all(n in _public(ref) and not hasattr(port, n) for n in waived)


def _params(fn):
    try:
        return list(inspect.signature(fn).parameters.values())
    except (TypeError, ValueError):  # a builtin without a signature
        return None


def _param_gaps(pkg: str, qual: str, ref_fn, port_fn) -> list[str]:
    """Where a reference call of ``qual`` would not bind the same way in
    the port: the reference's parameters (less the waived ones) must open
    the port's, same names and kinds; the port's extra ones need defaults."""
    ref, port = _params(ref_fn), _params(port_fn)
    if ref is None or port is None:
        return [] if ref == port else [f"{qual}: signature"]
    ref = [p for p in ref if p.name not in ROUTE_SWITCHES]
    head = [(p.name, p.kind) for p in port[: len(ref)]]
    gaps = [] if head == [(p.name, p.kind) for p in ref] else [
        f"{qual}: {[p.name for p in ref]} against {[p.name for p in port]}"]
    for p in port[len(ref):]:
        if p.default is p.empty and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD):
            gaps.append(f"{qual}: the port's extra parameter {p.name} has no default")
    return gaps


def _methods(cls) -> list[str]:
    return sorted(n for n in dir(cls) if not n.startswith("_")) + ["__init__"]


@pytest.mark.parametrize("pkg", PORTED)
def test_reference_methods_and_parameters_bind_the_same_in_the_port(pkg):
    ref = _reference(pkg)
    port = importlib.import_module(f"repro_torch.{pkg}")
    gaps = []
    for name in _public(ref):
        r, p = getattr(ref, name), getattr(port, name, None)
        if p is None:
            continue  # a waived name (test_every_reference_name_exists_in_the_port)
        if not inspect.isclass(r):
            if callable(r):
                gaps += _param_gaps(pkg, name, r, p)
            continue
        for m in _methods(r):
            qual = f"{name}.{m}"
            if not hasattr(p, m):
                gaps.append(f"{qual}: missing")
                continue
            rk, pk = type(inspect.getattr_static(r, m)), type(inspect.getattr_static(p, m))
            if rk is not pk:
                gaps.append(f"{qual}: a {rk.__name__} in the reference, a {pk.__name__} here")
            elif callable(getattr(r, m)) and not inspect.isclass(getattr(r, m)):
                gaps += _param_gaps(pkg, qual, getattr(r, m), getattr(p, m))
    assert gaps == []


def test_ops_under_the_reference_names():
    """``cone_scan_segments`` is the scan then ``compact_segments``;
    ``dequant_reconstruct`` is ``dequant``."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(np.cumsum(rng.standard_normal((300, 5)), axis=0))
    eps = torch.full_like(x, 0.5)
    lengths = torch.tensor([300, 7, 1, 150, 299])
    for ln in (None, lengths):
        got = ops.cone_scan_segments(x, eps, ln)
        want = ops.compact_segments(*ops.cone_scan(x, eps, ln))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    q = torch.from_numpy(rng.integers(-100, 100, (6, 40)).astype(np.int16))
    theta, slope, step = (torch.from_numpy(rng.standard_normal((6, 1)).astype(np.float32))
                          for _ in range(3))
    assert torch.equal(ops.dequant_reconstruct(q, theta, slope, step),
                       ops.dequant(q, theta, slope, step))


# ------------------------------------------- the repaired names, bit for bit
def _bits(a) -> np.ndarray:
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int64) if a.dtype == np.float64 else a


def _same(got, want):
    assert np.array_equal(_bits(got), _bits(want))


def _same_stream(got, want):
    assert (got.mode, got.eps_r, got.step) == (want.mode, want.eps_r, want.step)
    _same(np.float64(got.r_lo), np.float64(want.r_lo))
    _same(got.q, want.q)


def _walks(seed, s, t):
    rng = np.random.default_rng(seed)
    v = np.round(np.cumsum(rng.standard_normal((s, t)), axis=1) * 0.1, 4)
    v[1] = np.abs(v[1]) - np.abs(v[1]).min()  # a row whose minimum is +-0
    v[1, 5] = -0.0
    return v


def _bases(v, decimals=4):
    """Reference and port bases of each row (same segments, same base)."""
    cfg = dict(eps_b=0.05 * float(v.max() - v.min()), lam=1e-4)
    rc, pc = R.ShrinkConfig(**cfg), P.ShrinkConfig(**cfg)
    out = []
    for row in v:
        lo, hi = float(row.min()), float(row.max())
        rb = R.construct_base(R.extract_semantics(row, rc), len(row), lo, hi, rc)
        pb = P.construct_base(P.extract_semantics(torch.from_numpy(row), pc), len(row), lo, hi, pc)
        out.append((rb, pb))
    return out


def test_residuals_match_reference():
    v = _walks(0, 4, 3000)
    for row, (rb, pb) in zip(v, _bases(v)):
        r_ref = R.compute_residuals(row, rb)
        r_port = P.compute_residuals(torch.from_numpy(row), pb)
        _same(r_port, r_ref)
        for eps in (1e-1, 1e-3):
            want = R.quantize_residuals(r_ref, eps)
            got = P.quantize_residuals(r_port, eps)
            _same_stream(got, want)
            _same(P.dequantize_residuals(got), R.dequantize_residuals(want))
        want = R.quantize_exact(row, rb, 4)
        got = P.quantize_exact(torch.from_numpy(row), pb, 4)
        _same_stream(got, want)
        _same(P.dequantize_exact(got, pb, 4), R.dequantize_exact(want, rb, 4))
    with pytest.raises(ValueError, match="positive"):
        P.quantize_residuals(torch.zeros(3, dtype=torch.float64), 0.0)


@pytest.mark.parametrize("ragged", [False, True])
def test_batched_residuals_match_reference(ragged):
    v = _walks(1, 5, 2000)
    bases = _bases(v)
    preds = np.stack([R.base_predictions(rb) for rb, _ in bases])
    r = v - preds
    lengths = np.array([2000, 1, 0, 777, 1999]) if ragged else None
    for eps in (1e-2, 0.5):
        want = R.quantize_residuals_batch(r, eps, lengths=lengths)
        got = P.quantize_residuals_batch(torch.from_numpy(r), eps, lengths=lengths)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same_stream(g, w)
    want = R.quantize_exact_batch(v, preds, 4, lengths=lengths)
    got = P.quantize_exact_batch(torch.from_numpy(v), torch.from_numpy(preds), 4, lengths=lengths)
    for g, w in zip(got, want):
        _same_stream(g, w)


@pytest.mark.parametrize("pin", [False, True])
def test_extract_semantics_py_matches_reference(pin):
    v = _walks(2, 3, 1500)
    for row in v:
        kw = {}
        if pin:
            kw = dict(value_range=(float(v.min()), float(v.max())), n_hint=4096)
        for eps_b in (0.5, 0.05):
            rc, pc = R.ShrinkConfig(eps_b=eps_b, lam=1e-4), P.ShrinkConfig(eps_b=eps_b, lam=1e-4)
            want = R.extract_semantics_py(row, rc, **kw)
            got = P.extract_semantics_py(torch.from_numpy(row), pc, **kw)
            assert [dataclasses.astuple(s) for s in got] == [dataclasses.astuple(s) for s in want]
            # the port's batched scan against its oracle, as
            # tests/test_shrink_core.py holds the reference's (the spans are
            # the same intersections taken in another order)
            fast = P.extract_semantics(torch.from_numpy(row), pc, **kw)
            assert [(a.t0, a.length, a.level) for a in fast] == [
                (b.t0, b.length, b.level) for b in got]
            for a, b in zip(fast, got):
                assert a.theta == pytest.approx(b.theta)
                assert (a.psi_lo, a.psi_hi) == pytest.approx((b.psi_lo, b.psi_hi))
    assert P.extract_semantics_py(np.zeros(0), P.ShrinkConfig(eps_b=0.1)) == []
