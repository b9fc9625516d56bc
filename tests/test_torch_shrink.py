"""Parity of the port's codec with the reference codec, on the CPU.

* ``base_predictions_batch`` and ``quantize_pyramid_batch``: exact
  against the numpy functions;
* ``compress`` and ``compress_batch`` (``[S, T]``, ``backend="rans"``):
  SHRK bytes identical to the reference's;
* ``decompress_at`` at every tier and in between: bit-identical arrays;
* ``ProgressiveDecoder.prefix`` from every depth: one rANS launch a call,
  the reference's bits, and its state and errors when a layer fails;
* ``RangeQueryBatcher`` on a golden container: results and ``stats``;
* the golden ``.shrk`` fixtures: parsed, decoded and rebuilt byte for byte;
* ``convert``: the same state in both packages.
"""
import dataclasses
import pathlib
import struct

import jax  # noqa: F401
import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import base as ref_base
from repro.core import entropy as R_entropy
from repro.core import residuals as ref_res
from repro.serving.batching import RangeQuery as RefQuery
from repro.serving.batching import RangeQueryBatcher as RefBatcher

import repro_torch.core as P
from repro_torch import convert
from repro_torch import serving as P_serving
from repro_torch.core import base as port_base
from repro_torch.core import residuals as port_res
from repro_torch.core.errors import ConfigError
from repro_torch.kernels import rans

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

    monkeypatch.setattr(rans, "decode_rows", failed_launch)
    with pytest.raises(RuntimeError, match="failed to launch") as info:
        P.ProgressiveDecoder(cs, "cpu").prefix(len(TIERS) - 1)
    assert not isinstance(info.value, P.ShrinkError)


# a pyramid with an identity layer first (its tier lies above eps_b), three
# midpoint layers and the exact one, all rANS with 64 lanes
PYRAMID_TIERS = [1.0, 1e-1, 1e-2, 1e-3, 0.0]


def _pyramid_blob() -> bytes:
    v = _walk(9, 1, 700)[0]
    ref = R.ShrinkCodec.from_fraction(v, frac=0.05, lam=1e-5, backend="rans")
    return R.cs_to_bytes(ref.compress(v, PYRAMID_TIERS, decimals=4))


def _count_decode_launches(monkeypatch) -> list[int]:
    """Wrap ``kernels.rans.decode_rows``, the codec's row decoder; returns the
    list of lane counts of its calls."""
    lanes, orig = [], rans.decode_rows

    def counting(*args, **kwargs):
        lanes.append(args[6])
        return orig(*args, **kwargs)

    monkeypatch.setattr(rans, "decode_rows", counting)
    return lanes


def _bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float64).view(np.int64)


def test_prefix_from_every_depth_is_one_launch_and_matches_reference(monkeypatch):
    blob = _pyramid_blob()
    modes = [ly.mode for ly in R.cs_from_bytes(blob).pyramid.layers]
    assert modes == ["identity", "midpoint", "midpoint", "midpoint", "exact"]
    rd = R.ProgressiveDecoder(R.cs_from_bytes(blob))
    want = [rd.prefix(k) for k in range(-1, len(modes))]
    lanes = _count_decode_launches(monkeypatch)
    for j in range(-1, len(modes)):
        for k in range(j, len(modes)):
            pd = P.ProgressiveDecoder(P.cs_from_bytes(blob), "cpu")
            pd.prefix(j)
            paid = pd.layers_decoded
            lanes.clear()
            got = pd.prefix(k)
            need = sum(m != "identity" for m in modes[j + 1 : k + 1])
            assert lanes == ([64] if need else []), (j, k)
            assert pd.layers_decoded == paid + need and pd.depth == k
            assert np.array_equal(_bits(got.numpy()), _bits(want[k + 1]))
            # every shallower prefix is cached: no launch, the reference's bits
            for d in range(-1, k + 1):
                assert np.array_equal(_bits(pd.prefix(d).numpy()), _bits(want[d + 1]))
            assert lanes == ([64] if need else [])
            assert pd.guarantee() == R.ProgressiveDecoder(R.cs_from_bytes(blob)).guarantee(k)


def _short_words(payload: bytes) -> bytes:
    """A consistent rANS payload whose first plane lost its last 5 words."""
    npres = int(np.unpackbits(np.frombuffer(payload[19:51], np.uint8)).sum())
    at = 1 + 18 + 32 + 2 * npres + 4 * payload[18]
    (nwords,) = struct.unpack_from("<I", payload, at)
    return payload[:at] + struct.pack("<I", nwords - 5) + payload[at + 4 : -10]


FAULTS = {
    "corrupt_payload": lambda layer: setattr(layer, "payload", layer.payload[:9]),
    "short_words": lambda layer: setattr(layer, "payload", _short_words(layer.payload)),
    "quarantined": lambda layer: setattr(layer, "corrupt", True),
    "wrong_length": lambda layer: setattr(
        layer, "payload", R_entropy.encode_ints(np.arange(705), backend="rans")),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("start", [-1, 1])
def test_prefix_failure_mid_batch_leaves_the_reference_state(fault, start):
    """A fault in layer 3 of a prefix decoded from ``start`` to 4: the same
    error and ``layer=`` as the reference's layer-by-layer loop, the layers
    before it kept, the depth unmoved, and later prefixes alike."""
    blob = _pyramid_blob()
    decs = []
    for pkg, make in ((R, R.ProgressiveDecoder), (P, lambda cs: P.ProgressiveDecoder(cs, "cpu"))):
        cs = pkg.cs_from_bytes(blob)
        FAULTS[fault](cs.pyramid.layers[3])
        decs.append(make(cs))
    for dec in decs:
        dec.prefix(start)
    errs = []
    for dec in decs:
        with pytest.raises(ValueError) as info:
            dec.prefix(4)
        errs.append(info.value)
    rd, pd = decs
    assert type(errs[1]).__name__ == type(errs[0]).__name__ == "LayerCorruptError"
    assert errs[1].layer == errs[0].layer == 3
    assert pd.layers_decoded == rd.layers_decoded and pd.depth == rd.depth == start
    (pv, pg), (rv, rg) = pd.available(), rd.available()
    assert pg == rg and np.array_equal(_bits(pv.numpy()), _bits(rv))
    for k in (2, 1, 0):
        assert np.array_equal(_bits(pd.prefix(k).numpy()), _bits(rd.prefix(k)))
        assert pd.layers_decoded == rd.layers_decoded and pd.depth == rd.depth
    with pytest.raises(ValueError) as again:
        pd.prefix(4)
    assert type(again.value).__name__ == "LayerCorruptError" and again.value.layer == 3


def test_range_batcher_stats_unchanged_on_golden_container():
    blob = (GOLDEN / "golden_v4_ref.shrks").read_bytes()
    ref = RefBatcher(blob, cache_frames=2)
    port = P_serving.RangeQueryBatcher(blob, cache_frames=2, device="cpu")
    meta = R.routing_metadata(blob)
    rng = np.random.default_rng(19)
    specs = []
    for qid in range(48):
        sid = meta["series_ids"][qid % len(meta["series_ids"])]
        lo, hi = ref.span(sid)
        t0 = int(rng.integers(lo, hi - 1))
        t1 = int(rng.integers(t0 + 1, hi + 1))
        specs.append((qid, sid, t0, t1, [1.0, 1e-2, 0.005, 0.0][qid // 6 % 4]))
    for batch in (specs[:20], specs[20:]):
        for args in batch:
            ref.submit(RefQuery(*args))
            port.submit(P_serving.RangeQuery(*args))
        for w, g in zip(ref.run(), port.run()):
            assert (g.error is None) == (w.error is None), (g.error, w.error)
            assert (g.achieved, g.degraded) == (w.achieved, w.degraded)
            if w.error is None:
                assert np.array_equal(_bits(g.result.numpy()), _bits(w.result))
    assert port.stats == ref.stats
    assert port.stats["layers_decoded"] > 0 and port.stats["layer_hits"] > 0
