"""The port's baselines (``repro_torch.baselines``) against the reference's
(``repro.baselines``), on the CPU.

Every registry entry (lossy at eps = 1e-2 and 1e-3 of the range, lossless
at the dataset's decimals) gives byte-identical blobs from a CPU tensor and
from an ndarray, and decodes bit-identically (float64 bits compared) to
the reference's decode of the reference's blob; lossy decodes stay within
the reference test's bound (``tests/test_baselines.py``: f32 slope/value
storage costs a few ulp).  TRC's large-input path is checked in both its
entropy stages: zstd (where it imports) and the rANS planes that the card
machine, which has no zstd, takes.  The reference's adversarial inputs
and special floats, GD's width choice and Sim-Piece's merge are repeated
on the port.
"""
import importlib

import numpy as np
import pytest
import torch

import repro.baselines as R
import repro.baselines.standard as RS
from repro.data.synthetic import DATASETS, load

import repro_torch.baselines as P
import repro_torch.baselines.standard as PS


@pytest.fixture(scope="module")
def series():
    return load("MoteStrain", n=8000)


def _bits(x) -> np.ndarray:
    a = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.astype(np.float64).view(np.int64)


def test_registries_have_the_reference_keys():
    for name in ("LOSSY", "LOSSY_D", "LOSSLESS", "LOSSLESS_D"):
        assert sorted(getattr(P, name)) == sorted(getattr(R, name))


@pytest.mark.parametrize("name", sorted(R.LOSSY))
@pytest.mark.parametrize("eps_frac", [1e-2, 1e-3])
def test_lossy_blobs_and_decodes_equal_the_reference(series, name, eps_frac):
    eps = eps_frac * float(series.max() - series.min())
    want = R.LOSSY[name](series, eps)
    assert P.LOSSY[name](torch.from_numpy(series), eps) == want
    got = P.LOSSY_D[name](want, device="cpu")
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    assert np.array_equal(_bits(got), _bits(R.LOSSY_D[name](want)))
    assert np.max(np.abs(got.numpy() - series)) <= eps * (1 + 1e-3) + 1e-9


@pytest.mark.parametrize("name", sorted(R.LOSSLESS))
def test_lossless_blobs_and_decodes_equal_the_reference(series, name):
    d = DATASETS["MoteStrain"].decimals
    want = R.LOSSLESS[name](series, d)
    assert P.LOSSLESS[name](torch.from_numpy(series), d) == want
    got = P.LOSSLESS_D[name](want, device="cpu")
    assert np.array_equal(_bits(got), _bits(R.LOSSLESS_D[name](want)))
    if name == "GD":
        assert np.array_equal(np.round(got.numpy(), d), np.round(series, d))
    else:
        assert np.array_equal(_bits(got), _bits(series))


@pytest.mark.parametrize("mod", ["apca", "gd", "gorilla", "hire", "lfzip", "simpiece"])
def test_an_ndarray_on_the_cpu_is_the_tensor(series, mod):
    ref, port = (importlib.import_module(f"{pkg}.baselines.{mod}") for pkg in ("repro",
                                                                            "repro_torch"))
    arg = (4,) if mod == "gd" else (() if mod == "gorilla" else (0.01,))
    assert port.compress(series, *arg, device="cpu") == ref.compress(series, *arg)


@pytest.mark.parametrize("zstd", [True, False])
def test_trc_byte_planes(monkeypatch, zstd):
    """A series past TRC's 150,000-byte range-coder limit: the byte planes
    through zstd (mode 1) or, without zstd, through the rANS coder (mode 2,
    the kernels' route on the card)."""
    if zstd and RS._zstd is None:
        pytest.skip("zstandard is not installed")
    if not zstd:
        monkeypatch.setattr(RS, "_zstd", None)
        monkeypatch.setattr(PS, "_zstd", None)
    v = np.round(np.cumsum(np.random.default_rng(5).standard_normal(40_000)) * 0.1, 4)
    v[7] = -0.0
    want = RS.trc_c.compress(v)
    assert want[12] == (1 if zstd else 2)
    assert PS.trc_c.compress(torch.from_numpy(v)) == want
    got = PS.trc_c.decompress(want, device="cpu")
    assert np.array_equal(_bits(got), _bits(v))


_ADVERSARIAL = {
    "empty": np.zeros(0, dtype=np.float64),
    "len1": np.array([3.25]),
    "constant": np.full(257, -7.125),
    "ramp": np.round(np.linspace(-5.0, 5.0, 300), 4),
    "altsign": np.round(np.tile([1.5, -1.5], 150), 4),
}


@pytest.mark.parametrize("case", sorted(_ADVERSARIAL))
def test_gorilla_adversarial_roundtrip(case):
    v = _ADVERSARIAL[case]
    blob = P.gorilla.compress(torch.from_numpy(v))
    assert blob == R.gorilla.compress(v)
    out = P.gorilla.decompress(blob, device="cpu")
    assert out.shape == v.shape and np.array_equal(_bits(out), _bits(v))


def test_gorilla_special_float_bit_patterns():
    v = np.array([0.0, -0.0, np.inf, -np.inf, 1e-310, np.finfo(np.float64).max])
    blob = P.gorilla.compress(torch.from_numpy(v))
    assert blob == R.gorilla.compress(v)
    assert np.array_equal(_bits(P.gorilla.decompress(blob, device="cpu")), _bits(v))
    rng = np.random.default_rng(0).standard_normal(500)  # full-entropy mantissas
    assert np.array_equal(_bits(P.gorilla.decompress(P.gorilla.compress(
        torch.from_numpy(rng)), device="cpu")), _bits(rng))


@pytest.mark.parametrize("name", ["simpiece", "lfzip"])
@pytest.mark.parametrize("case", sorted(_ADVERSARIAL))
def test_lossy_adversarial_roundtrip(name, case):
    ref, port = (importlib.import_module(f"{pkg}.baselines.{name}") for pkg in ("repro",
                                                                             "repro_torch"))
    v = _ADVERSARIAL[case]
    rng = float(v.max() - v.min()) if v.size else 0.0
    eps = 0.01 * rng if rng > 0 else 0.01
    blob = port.compress(torch.from_numpy(v), eps)
    assert blob == ref.compress(v, eps)
    out = port.decompress(blob, device="cpu")
    assert out.shape == v.shape
    assert np.array_equal(_bits(out), _bits(ref.decompress(blob)))
    if v.size:
        assert np.max(np.abs(out.numpy() - v)) <= eps * (1 + 1e-3) + 1e-9, case


@pytest.mark.parametrize("name", ["simpiece", "lfzip"])
def test_lossy_baselines_degenerate_eps_still_bounded(name):
    port = importlib.import_module(f"repro_torch.baselines.{name}")
    ref = importlib.import_module(f"repro.baselines.{name}")
    v = np.round(np.tile([0.001, -0.001, 0.0015], 100), 4)
    blob = port.compress(torch.from_numpy(v), 1e-5)
    assert blob == ref.compress(v, 1e-5)
    out = port.decompress(blob, device="cpu").numpy()
    assert np.max(np.abs(out - v)) <= 1e-5 * (1 + 1e-3) + 1e-12


@pytest.mark.parametrize("seed", [1, 2])
def test_gd_deviation_bit_choice(seed):
    v = np.round(np.linspace(0, 1, 1000)
                 + 0.001 * np.random.default_rng(seed).standard_normal(1000), 3)
    ints = np.round(v * 1000).astype(np.int64)
    want = R.gd.choose_deviation_bits(ints)
    assert P.gd.choose_deviation_bits(torch.from_numpy(ints)) == want
    assert P.gd.choose_deviation_bits(ints) == want
    assert 0 <= want[0] <= 64 and want[1] > 0


def test_simpiece_merges_segments():
    v = load("Pressure", n=20_000)
    eps = 0.005 * float(v.max() - v.min())
    segs = P.simpiece.extract_segments(torch.from_numpy(v), eps)
    assert segs == R.simpiece.extract_segments(v, eps)
    blob = P.simpiece.compress(torch.from_numpy(v), eps)
    assert blob == R.simpiece.compress(v, eps)
    assert len(blob) < len(segs) * 12 + 64


def test_hire_structure_roundtrip():
    v = load("Wafer", n=4097)  # non power of two
    eps = 0.01 * float(v.max() - v.min())
    blob = P.hire.compress(torch.from_numpy(v), eps)
    assert blob == R.hire.compress(v, eps)
    out = P.hire.decompress(blob, device="cpu")
    assert np.array_equal(_bits(out), _bits(R.hire.decompress(blob)))
    assert np.max(np.abs(out.numpy() - v)) <= eps * (1 + 1e-9)


def test_bitio_pack_fixed_is_numpy_packbits():
    from repro.baselines import bitio as RB
    from repro_torch.baselines import bitio as PB

    rng = np.random.default_rng(4)
    for width in (1, 3, 8, 13, 40, 63):
        vals = rng.integers(0, 2**width, 777, dtype=np.uint64) if width < 63 else \
            rng.integers(0, 2**62, 777).astype(np.uint64)
        blob = PB.pack_fixed(torch.from_numpy(vals.astype(np.int64)), width)
        assert blob == RB.pack_fixed(vals, width)
        assert np.array_equal(PB.unpack_fixed(blob, 777, width, "cpu").numpy(),
                              RB.unpack_fixed(blob, 777, width))
