"""The port's CUDA kernels and device codec on the card (marker ``cuda``).

Each kernel against its plain torch version on the same device tensors,
exactly; the device codec against the CPU codec (SHRK bytes) and against
the reference codec (``repro.core``, which needs numpy and not JAX, so
this file runs on a card machine without JAX).  Without a card every test
here skips; run them on one with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import repro.core as R

import repro_torch.core as P
from repro_torch.core import entropy
from repro_torch.core.phases import fluctuation_table
from repro_torch.kernels import cone_scan as cs_mod
from repro_torch.kernels import ops
from repro_torch.kernels import rans

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _walk(seed: int, s: int, t: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.round(np.cumsum(rng.standard_normal((s, t)), axis=1) * 0.1, 4)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cone_scan_kernel_equals_plain(card, dtype):
    v = torch.as_tensor(_walk(0, 96, 3000), device=card)
    cfg = P.ShrinkConfig(eps_b=0.02 * float(v.max() - v.min()))
    _, eps = fluctuation_table(v, v.amax(1) - v.amin(1), cfg)
    x, e = v.T.contiguous().to(dtype), eps.T.contiguous().to(dtype)
    lengths = torch.as_tensor(
        np.random.default_rng(0).integers(1, 3001, 96), dtype=torch.int32, device=card
    )
    for ln in (None, lengths):
        before = ops.launches["cone_scan"]
        got = cs_mod.cone_scan(x, e, ln)
        assert ops.launches["cone_scan"] == before + 1
        want = cs_mod.cone_scan_plain(x, e, ln)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("k", [64, 17, 1])
def test_rans_kernels_equal_plain(card, k):
    rng = np.random.default_rng(k)
    lens = [k * 40 + 3, k * 40, max(1, k - 1)]
    sym = np.full((3, max(lens)), 256, dtype=np.int16)
    freqs = np.zeros((3, 256), dtype=np.int64)
    for i, n in enumerate(lens):
        row = rng.integers(0, 1 + 60 * i, n)
        sym[i, :n] = row
        freqs[i] = entropy._rans_normalize_freqs(torch.as_tensor(np.bincount(row, minlength=256)))
    s_d, f_d = torch.as_tensor(sym, device=card), torch.as_tensor(freqs, device=card)
    got = rans.encode_rows(s_d, f_d, k)
    want = rans.encode_rows(s_d.cpu(), f_d.cpu(), k)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    states, words, counts = got
    off = torch.cat([counts.new_zeros(1), counts.cumsum(0)[:-1]])
    ns = torch.tensor(lens, dtype=torch.int64, device=card)
    d_got = rans.decode_rows(states, f_d, words, off, counts, ns, k)
    d_want = rans.decode_rows_plain(
        states.cpu(), f_d.cpu(), words.cpu(), off.cpu(), counts.cpu(), ns.cpu(), k,
        d_got[0].shape[1],
    )
    for a, b in zip(d_got, d_want):
        assert torch.equal(a.cpu(), b)
    for i, n in enumerate(lens):
        assert torch.equal(d_got[0][i, :n].cpu().long(), torch.as_tensor(sym[i, :n]).long())


def test_device_codec_bytes_equal_cpu_and_reference(card):
    v = _walk(1, 12, 4096)
    tiers = [1e-1, 1e-2, 1e-3, 0.0]
    dev = P.ShrinkCodec.from_fraction(v, frac=0.05, device=card)
    cpu = P.ShrinkCodec(dev.config, device="cpu")
    ref = R.ShrinkCodec.from_fraction(v, frac=0.05, backend="rans")
    ops.reset_launches()
    got = [P.cs_to_bytes(cs) for cs in dev.compress_batch(v, tiers, decimals=4)]
    assert all(ops.launches[name] > 0 for name in ("cone_scan", "rans_encode"))
    assert got == [P.cs_to_bytes(cs) for cs in cpu.compress_batch(v, tiers, decimals=4)]
    assert got == [R.cs_to_bytes(cs) for cs in ref.compress_batch(v, tiers, decimals=4)]
    for i, blob in enumerate(got):
        cs = P.cs_from_bytes(blob)
        out = dev.decompress_at(cs, 0.0)
        assert out.device.type == "cuda" and out.dtype == torch.float64
        np.testing.assert_array_equal(out.cpu().numpy(), v[i])
        np.testing.assert_array_equal(
            dev.decompress_at(cs, 3e-3).cpu().numpy(), R.decompress_at(R.cs_from_bytes(blob), 3e-3)
        )
    assert ops.launches["rans_decode"] > 0
