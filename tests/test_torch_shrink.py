"""Parity of the port's codec with the reference codec, on the CPU.

* ``base_predictions_batch`` and ``quantize_pyramid_batch``: exact
  against the numpy functions;
* ``compress`` and ``compress_batch`` (``[S, T]``, ``backend="rans"``):
  SHRK bytes identical to the reference's;
* ``decompress_at`` at every tier and in between: bit-identical arrays;
* the golden ``.shrk`` fixtures: parsed, decoded and rebuilt byte for byte;
* ``convert``: the same state in both packages.
"""
import dataclasses
import pathlib

import jax  # noqa: F401
import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import base as ref_base
from repro.core import residuals as ref_res

import repro_torch.core as P
from repro_torch import convert
from repro_torch.core import base as port_base
from repro_torch.core import residuals as port_res
from repro_torch.core.errors import ConfigError
from repro_torch.kernels import ops

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
# the fixture constants of tests/golden/regen.py
N, DECIMALS, EPS_TARGETS = 1536, 3, [1e-2, 0.0]
TIERS = [1e-1, 1e-2, 1e-3, 0.0]


def _golden_series() -> np.ndarray:
    t = np.arange(N, dtype=np.float64)
    v = np.sin(t * 0.02) * 2.5 + 0.3 * np.sign(np.sin(t * 0.15)) + 1e-3 * t
    return np.round(v, DECIMALS)


def _golden_config():
    v = _golden_series()
    return P.ShrinkConfig(eps_b=0.05 * float(v.max() - v.min()), lam=1e-3)


def _walk(seed: int, s: int, t: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.round(np.cumsum(rng.standard_normal((s, t)), axis=1) * 0.1, 4)


def _codecs(v, frac=0.05, lam=1e-5):
    ref = R.ShrinkCodec.from_fraction(v, frac=frac, lam=lam, backend="rans")
    port = P.ShrinkCodec(
        convert.config_from_reference(dataclasses.asdict(ref.config)), backend="rans",
        device="cpu",
    )
    return ref, port


BATCHES = {
    "gateway_small": (0, 6, 2048, 0.05, 1e-5, TIERS, 4),
    "tight_base": (1, 4, 1000, 0.01, 1e-4, [0.02, 0.005, 0.0], 4),
    "lossy_only": (2, 3, 777, 0.05, 1e-5, [0.05, 1e-3], None),
    "sub_k_series": (3, 5, 40, 0.05, 1e-5, TIERS, 4),
}


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_compress_batch_bytes_identical(name):
    seed, s, t, frac, lam, tiers, dec = BATCHES[name]
    v = _walk(seed, s, t)
    ref, port = _codecs(v, frac, lam)
    want = [R.cs_to_bytes(cs) for cs in ref.compress_batch(v, tiers, decimals=dec)]
    got = port.compress_batch(v, tiers, decimals=dec)
    assert [P.cs_to_bytes(cs) for cs in got] == want
    for i, cs in enumerate(got):
        ref_cs = R.cs_from_bytes(want[i])
        for eps in sorted(set(tiers + [0.5 * tiers[0], 1e9])):
            if eps == 0.0 and dec is None:
                continue
            a = port.decompress_at(cs, eps)
            assert a.dtype == torch.float64 and a.device.type == "cpu"
            np.testing.assert_array_equal(a.numpy(), R.decompress_at(ref_cs, eps))
            assert np.abs(a.numpy() - v[i]).max() <= max(eps, cs.eps_b_practical)


@pytest.mark.parametrize("seed", [0, 1])
def test_compress_bytes_identical(seed):
    v = _walk(seed + 10, 1, 3000)[0]
    ref, port = _codecs(v)
    want = ref.compress(v, TIERS, decimals=4)
    got = port.compress(torch.as_tensor(v), TIERS, decimals=4)
    assert P.cs_to_bytes(got) == R.cs_to_bytes(want)
    vr = (float(v.min()) - 1.0, float(v.max()))
    want = ref.compress(v, TIERS, decimals=4, value_range=vr, n_hint=10**6)
    got = port.compress(v, TIERS, decimals=4, value_range=vr, n_hint=10**6)
    assert P.cs_to_bytes(got) == R.cs_to_bytes(want)


EDGE_SERIES = {
    "empty": np.zeros(0),
    "one_sample": np.array([1.5]),
    "two_samples": np.array([1.5, 2.0]),
    "sub_k": np.round(np.random.default_rng(0).standard_normal(63), 3),
    "constant": np.full(100, 3.25),
}


@pytest.mark.parametrize("name", sorted(EDGE_SERIES))
@pytest.mark.parametrize("tiers,dec", [([0.05, 0.0], 3), ([0.01], None)])
def test_compress_edge_series_bytes_identical(name, tiers, dec):
    v = EDGE_SERIES[name]
    want = R.cs_to_bytes(R.ShrinkCodec(R.ShrinkConfig(eps_b=0.1), backend="rans").compress(
        v, tiers, decimals=dec))
    port = P.ShrinkCodec(P.ShrinkConfig(eps_b=0.1), backend="rans", device="cpu")
    assert P.cs_to_bytes(port.compress(v, tiers, decimals=dec)) == want
    if v.size:
        np.testing.assert_array_equal(
            port.decompress_at(P.cs_from_bytes(want), tiers[-1]).numpy(),
            R.decompress_at(R.cs_from_bytes(want), tiers[-1]),
        )


def test_progressive_decoder_matches_reference_layer_by_layer():
    v = _walk(4, 1, 2500)[0]
    ref, port = _codecs(v)
    blob = P.cs_to_bytes(port.compress(v, TIERS, decimals=4))
    rd = R.ProgressiveDecoder(R.cs_from_bytes(blob))
    pd = P.ProgressiveDecoder(P.cs_from_bytes(blob), device="cpu")
    for k in range(-1, len(TIERS)):
        np.testing.assert_array_equal(pd.prefix(k).numpy(), rd.prefix(k))
        assert pd.guarantee() == rd.guarantee()
    assert pd.layers_decoded == rd.layers_decoded
    np.testing.assert_array_equal(pd.at(0.0).numpy(), v)


def test_base_predictions_batch_exact():
    v = _walk(5, 4, 1200)
    ref, port = _codecs(v, 0.02)
    bases = [ref.build_base(row) for row in v]
    want = ref_base.base_predictions_batch(bases)
    pbases = [P.cs_from_bytes(R.cs_to_bytes(ref.compress(row, [0.01]))).base for row in v]
    got = port_base.base_predictions_batch(pbases, "cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    assert port_base.base_predictions(pbases[1], "cpu").tolist() == want[1].tolist()


def test_quantize_pyramid_batch_exact():
    v = _walk(6, 5, 900)
    rng = np.random.default_rng(0)
    preds = v + rng.standard_normal(v.shape) * 0.05
    preds[2] = v[2]  # a row whose coarse tiers are identity layers
    tiers = ref_res.normalize_tiers([0.1, 0.01, 1e-3, 0.0], 4)
    assert port_res.normalize_tiers([0.01, 0.1, 0.0, 1e-3], 4) == tiers
    want = ref_res.quantize_pyramid_batch(v, preds, tiers, 4)
    got = port_res.quantize_pyramid_batch(torch.as_tensor(v), torch.as_tensor(preds), tiers, 4)
    for rw, gw in zip(want, got):
        for a, b in zip(rw, gw):
            assert (a is None) == (b is None)
            if a is None:
                continue
            assert (a.eps_r, a.step, a.r_lo, a.mode) == (b.eps_r, b.step, b.r_lo, b.mode)
            np.testing.assert_array_equal(b.q.numpy(), a.q)


def test_golden_fixtures_decode_and_rebuild():
    v = _golden_series()
    codec = P.ShrinkCodec(_golden_config(), backend="rans", device="cpu")
    rng = float(v.max() - v.min())
    builds = {
        "golden_v4.shrk": EPS_TARGETS,
        "golden_v4_pyramid.shrk": [1e-1 * rng, 1e-2 * rng, 1e-3 * rng, 0.0],
    }
    for name, tiers in builds.items():
        blob = (GOLDEN / name).read_bytes()
        cs = P.cs_from_bytes(blob)
        assert P.cs_to_bytes(cs) == blob
        np.testing.assert_array_equal(codec.decompress_at(cs, 0.0).numpy(), v)
        assert P.cs_to_bytes(codec.compress(v, tiers, decimals=DECIMALS)) == blob


def test_convert_carries_state():
    v = _walk(8, 1, 600)[0]
    ref, _ = _codecs(v)
    cfg = convert.config_from_reference(dataclasses.asdict(ref.config))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref.config)
    blob = R.cs_to_bytes(ref.compress(v, TIERS, decimals=4))
    cs = convert.series_from_reference(blob)
    assert P.cs_to_bytes(cs) == blob
    assert cs.base.n == v.size and cs.tiers() == TIERS
    with pytest.raises(ValueError):
        convert.config_from_reference({"eps_b": 1.0, "bogus": 2})


def test_ragged_batch_and_unported_backend_raise():
    """Ragged batches and every backend now run; what still raises is a
    bad argument, as in the reference."""
    port = P.ShrinkCodec(P.ShrinkConfig(eps_b=0.1), device="cpu")
    ref = R.ShrinkCodec(R.ShrinkConfig(eps_b=0.1))
    ragged = [np.zeros(5), np.arange(7.0)]
    assert [P.cs_to_bytes(c) for c in port.compress_batch(ragged, [0.1])] == [
        R.cs_to_bytes(c) for c in ref.compress_batch(ragged, [0.1])
    ]
    assert len(port.compress_batch(np.zeros((2, 8)), [0.1], lengths=[8, 3])) == 2
    with pytest.raises(ValueError, match="lengths"):
        port.compress_batch(np.zeros((2, 8)), [0.1], lengths=[8, 9])
    with pytest.raises(ValueError, match="max_buckets"):
        port.compress_batch(ragged, [0.1], max_buckets=0)
    with pytest.raises(ValueError, match="unknown backend"):
        P.ShrinkCodec(P.ShrinkConfig(eps_b=0.1), backend="lz4", device="cpu").compress(
            np.arange(6.0), [0.1]
        )
    out = port.compress_batch([np.arange(6.0), np.arange(6.0)], [0.1])
    assert len(out) == 2


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert P.ShrinkCodec(P.ShrinkConfig(eps_b=0.1)).device.type == "cuda"
    else:
        with pytest.raises(ConfigError, match="CUDA"):
            P.ShrinkCodec(P.ShrinkConfig(eps_b=0.1))
        with pytest.raises(ConfigError, match="CUDA"):
            P.decompress_at(P.cs_from_bytes((GOLDEN / "golden_v4.shrk").read_bytes()), 0.0)


def test_empty_series_batch_matches_reference():
    v = np.zeros((3, 0))
    ref = R.ShrinkCodec(R.ShrinkConfig(eps_b=0.1), backend="rans")
    port = P.ShrinkCodec(P.ShrinkConfig(eps_b=0.1), backend="rans", device="cpu")
    want = [R.cs_to_bytes(c) for c in ref.compress_batch(v, TIERS, decimals=4)]
    assert [P.cs_to_bytes(c) for c in port.compress_batch(v, TIERS, decimals=4)] == want


def test_decoder_types_corrupt_payloads_and_passes_kernel_errors(monkeypatch):
    """A payload that fails to parse is a typed ShrinkError; an error of the
    kernel layer (a failed build or launch) is not turned into one."""
    v = _walk(9, 1, 700)[0]
    _, port = _codecs(v)
    cs = port.compress(v, TIERS, decimals=4)
    layer = next(ly for ly in cs.pyramid.layers if ly.mode != "identity")
    good = layer.payload
    layer.payload = good[:9]  # the header cut short
    with pytest.raises(P.ShrinkError):
        P.ProgressiveDecoder(cs, "cpu").prefix(len(TIERS) - 1)
    layer.payload = good

    def failed_launch(*args, **kwargs):
        raise RuntimeError("CUDA kernel rans_decode failed to launch: cudaError 209")

    monkeypatch.setattr(ops, "rans_decode_rows", failed_launch)
    with pytest.raises(RuntimeError, match="failed to launch") as info:
        P.ProgressiveDecoder(cs, "cpu").prefix(len(TIERS) - 1)
    assert not isinstance(info.value, P.ShrinkError)
