"""Parity of the port's entropy backends and its ``best`` cost model with
the reference, on the CPU.

* ``encode_ints`` / ``encode_ints_batch``: blobs byte-identical for each
  of ``rc``, ``raw``, ``bitpack``, ``zstd`` (where ``zstandard`` imports,
  as in the reference) and ``best`` with ``exhaustive`` True and False;
* ``predict_backend_sizes`` dicts and ``choose_backend`` picks equal;
* reference blobs of every tag decode, alone and in a batch;
* the codec's default backend is the reference's: ``ShrinkCodec`` with no
  ``backend`` gives the reference's SHRK bytes.

Extreme int64 values go through ``raw`` and ``bitpack`` only: the
reference's median arithmetic overflows on them in the other backends.
"""
import dataclasses

import jax  # noqa: F401  (parity suites import both packages)
import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import entropy as ref_entropy

import repro_torch.core as P
from repro_torch.core import entropy
from repro_torch.core.errors import CorruptFrameError, TruncatedArchiveError

_RNG = np.random.default_rng(20261017)


def _streams() -> dict[str, np.ndarray]:
    r = _RNG
    return {
        "empty": np.zeros(0, np.int64),
        "one": np.array([5]),
        "constant": np.full(100, 7),
        "sub_k": r.integers(-5, 5, 40),
        "exactly_k": r.integers(-2**20, 2**20, 64),
        "small_alphabet": r.integers(0, 3, 5000),
        "wide": r.integers(-2**40, 2**40, 300),
        "gaussian": (r.standard_normal(3000) * 1000).astype(np.int64),
        "runs": np.repeat(r.integers(-50, 50, 30), 40),
        "skewed": np.where(r.random(4000) < 0.97, 0, r.integers(-9000, 9000, 4000)),
        "big_alphabet": r.integers(-6000, 6000, 700),
    }


STREAMS = _streams()
BACKENDS = ["rc", "raw", "bitpack", "zstd", "rans"]


def _skip_absent(backend: str) -> None:
    if backend not in ref_entropy.available_backends():
        pytest.skip(f"{backend} needs the optional zstandard package")


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_encode_ints_bytes_identical(backend, name):
    _skip_absent(backend)
    q = STREAMS[name]
    want = ref_entropy.encode_ints(q, backend=backend)
    assert entropy.encode_ints(torch.as_tensor(q), backend=backend) == want
    np.testing.assert_array_equal(entropy.decode_ints(want, device="cpu").numpy(), q)


@pytest.mark.parametrize("exhaustive", [False, True])
def test_best_batch_bytes_identical(exhaustive):
    qs = [STREAMS[n] for n in sorted(STREAMS)]
    want = [ref_entropy.encode_ints(q, backend="best", exhaustive=exhaustive) for q in qs]
    got = entropy.encode_ints_batch(
        [torch.as_tensor(q) for q in qs], backend="best", exhaustive=exhaustive
    )
    assert got == want
    assert entropy.encode_ints(torch.as_tensor(qs[3]), exhaustive=exhaustive) == want[3]
    if not exhaustive:
        assert ref_entropy.encode_ints_batch(qs, backend="best") == want


def test_batches_group_streams_without_changing_bytes():
    """A rectangular batch, a ragged batch and one call per stream give the
    same blobs for every backend."""
    rect = np.stack([_RNG.integers(-500, 500, 700) for _ in range(5)])
    ragged = [rect[0], rect[1, :65], rect[2, :63], rect[3, :1], rect[4, :0], rect[0, :640]]
    for backend in entropy.available_backends() + ["best"]:
        want = [ref_entropy.encode_ints(q, backend=backend) for q in rect]
        assert entropy.encode_ints_batch(torch.as_tensor(rect), backend=backend) == want
        want = [ref_entropy.encode_ints(q, backend=backend) for q in ragged]
        got = entropy.encode_ints_batch([torch.as_tensor(q) for q in ragged], backend=backend)
        assert got == want, backend


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_cost_model_equal(name):
    q = STREAMS[name]
    assert entropy.predict_backend_sizes(torch.as_tensor(q)) == ref_entropy.predict_backend_sizes(q)
    assert entropy.choose_backend(torch.as_tensor(q)) == ref_entropy.choose_backend(q)


def test_available_backends_and_names_mirror_reference():
    assert entropy.available_backends() == ref_entropy.available_backends()
    for tag in range(6):
        assert entropy.backend_name(tag) == ref_entropy.backend_name(tag)


@pytest.mark.parametrize("backend", ["raw", "bitpack"])
def test_extreme_int64_through_packers(backend):
    q = np.array([-(2**63), 2**63 - 1, 0, -1, 2**62], dtype=np.int64)
    want = ref_entropy.encode_ints(q, backend=backend)
    assert entropy.encode_ints(torch.as_tensor(q), backend=backend) == want
    np.testing.assert_array_equal(entropy.decode_ints(want, device="cpu").numpy(), q)


def test_reference_blobs_of_every_tag_decode_in_one_batch():
    blobs, qs = [], []
    for backend in ref_entropy.available_backends():
        for name in ("sub_k", "gaussian", "empty", "runs"):
            qs.append(STREAMS[name])
            blobs.append(ref_entropy.encode_ints(STREAMS[name], backend=backend))
    tags = {b[0] for b in blobs}
    assert tags >= {0, 2, 3, 4}
    for got, q in zip(entropy.decode_ints_batch(blobs, device="cpu"), qs):
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), q)


def test_corrupt_host_payloads_raise_typed_errors():
    blob = ref_entropy.encode_ints(STREAMS["gaussian"], backend="bitpack")
    with pytest.raises(TruncatedArchiveError):
        entropy.decode_ints(blob[:-3], device="cpu")
    with pytest.raises(CorruptFrameError):
        entropy.decode_ints(blob + b"\x00", device="cpu")
    with pytest.raises(TruncatedArchiveError):
        entropy.decode_ints(b"", device="cpu")


def test_missing_zstandard_behaves_as_reference(monkeypatch):
    """Where zstandard does not import, ``best`` never picks zstd and naming
    it raises, as in the reference."""
    q = torch.as_tensor(STREAMS["runs"])
    monkeypatch.setattr(entropy, "_zstd", None)
    assert "zstd" not in entropy.available_backends()
    assert "zstd" not in entropy.predict_backend_sizes(q)
    assert entropy.choose_backend(q) != "zstd"
    with pytest.raises(RuntimeError, match="zstandard"):
        entropy.encode_ints(q, backend="zstd")
    with pytest.raises(RuntimeError, match="zstandard"):
        entropy.decode_ints(b"\x01" + bytes(20), device="cpu")
    monkeypatch.setattr(ref_entropy, "_zstd", None)
    assert entropy.encode_ints(q) == ref_entropy.encode_ints(STREAMS["runs"])


def _walk(seed: int, s: int, t: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.round(np.cumsum(rng.standard_normal((s, t)), axis=1) * 0.1, 4)


@pytest.mark.parametrize("tiers,dec", [([1e-1, 1e-2, 1e-3, 0.0], 4), ([0.05, 1e-3], None)])
def test_default_backend_gives_reference_bytes(tiers, dec):
    """``from_fraction`` with no ``backend`` in both packages: the same SHRK
    bytes for a single series, a rectangular batch and a ragged batch."""
    v = _walk(3, 4, 1500)
    ref = R.ShrinkCodec.from_fraction(v, frac=0.05)
    port = P.ShrinkCodec.from_fraction(v, frac=0.05, device="cpu")
    assert port.backend == ref.backend == "best"
    assert dataclasses.asdict(port.config) == dataclasses.asdict(ref.config)
    want = R.cs_to_bytes(ref.compress(v[0], tiers, decimals=dec))
    assert P.cs_to_bytes(port.compress(v[0], tiers, decimals=dec)) == want
    want = [R.cs_to_bytes(c) for c in ref.compress_batch(v, tiers, decimals=dec)]
    assert [P.cs_to_bytes(c) for c in port.compress_batch(v, tiers, decimals=dec)] == want
    ragged = [v[0], v[1, :700], v[2, :40], v[3, :1]]
    want = [R.cs_to_bytes(c) for c in ref.compress_batch(ragged, tiers, decimals=dec)]
    assert [P.cs_to_bytes(c) for c in port.compress_batch(ragged, tiers, decimals=dec)] == want
    tags = {ly.payload[0] for b in want for ly in R.cs_from_bytes(b).pyramid.layers if ly.payload}
    assert len(tags) > 1  # the cost model really routed streams to several backends
