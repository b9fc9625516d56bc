"""Parity of the port's rANS coder with the reference, on the CPU.

* plain ``encode_rows``/``decode_rows`` against the reference engine
  ``repro.kernels.rans`` on its jit'd-scan route (``xla``): states, word
  streams and symbols identical;
* ``encode_ints_batch(..., "rans")`` / ``decode_ints`` against
  ``repro.core.entropy``: blobs byte-identical, including empty,
  length-1, fewer-than-64-symbol and 8-plane streams;
* ``decode_ints_batch`` over mixed lane and plane counts, one launch a lane
  count, and ``decode_ints_until_error`` stopping where a loop would.
"""
import struct

import jax  # noqa: F401
import numpy as np
import pytest
import torch

from repro.core import entropy as ref_entropy
from repro.kernels import rans as ref_rans

from repro_torch.core import entropy
from repro_torch.core.errors import CorruptFrameError, FormatError
from repro_torch.kernels import ops
from repro_torch.kernels import rans

_RNG = np.random.default_rng(20261016)


def _rows(spec):
    streams = [_RNG.integers(0, hi, n).astype(np.int64) for n, hi in spec]
    cols = max(1, max(s.size for s in streams))
    sym = np.full((len(streams), cols), 256, dtype=np.int64)
    freqs = np.empty((len(streams), 256), dtype=np.int64)
    for i, s in enumerate(streams):
        sym[i, : s.size] = s
        freqs[i] = ref_entropy._rans_normalize_freqs(np.bincount(s, minlength=256))
    return sym, freqs, [s.size for s in streams]


ROW_SPECS = {
    "one_row_one_step": [(64, 16)],
    "ragged_rows": [(200, 8), (64, 250), (130, 2)],
    "four_rows_two_steps": [(128, 256)] * 4,
    "single_symbol_rows": [(96, 1), (96, 1)],
    "long_rows": [(3000, 200), (2500, 3)],
}


@pytest.mark.parametrize("name", sorted(ROW_SPECS))
def test_encode_decode_rows_match_reference_engine(name):
    sym, freqs, lens = _rows(ROW_SPECS[name])
    st_r, w_r = ref_rans.encode_rows(sym.astype(np.uint16), freqs, route="xla")
    states, words, counts = rans.encode_rows(
        torch.as_tensor(sym).to(torch.int16), torch.as_tensor(freqs), 64
    )
    np.testing.assert_array_equal(states.numpy(), st_r.astype(np.int64))
    splits = np.split(words.numpy().view(np.uint16), np.cumsum(counts.numpy())[:-1])
    assert len(splits) == len(w_r)
    for a, b in zip(splits, w_r):
        np.testing.assert_array_equal(a, b)
    n = sym.shape[1]
    out_r = ref_rans.decode_rows(st_r, freqs, w_r, n, route="xla")
    off = np.concatenate([[0], np.cumsum(counts.numpy())[:-1]])
    syms, used = rans.decode_rows(
        states, torch.as_tensor(freqs), words, torch.as_tensor(off), counts,
        torch.as_tensor(lens, dtype=torch.int64), 64,
    )
    assert used.tolist() == counts.tolist()
    for i, ln in enumerate(lens):
        np.testing.assert_array_equal(syms[i, :ln].numpy(), out_r[i, :ln])
        np.testing.assert_array_equal(syms[i, :ln].numpy(), sym[i, :ln])


@pytest.mark.parametrize("k", [1, 5, 63])
def test_fewer_lanes_round_trip(k):
    sym, freqs, lens = _rows([(k * 3 + 1, 40), (k, 7)])
    states, words, counts = rans.encode_rows(
        torch.as_tensor(sym).to(torch.int16), torch.as_tensor(freqs), k
    )
    assert states.shape == (2, k)
    off = torch.cat([torch.zeros(1, dtype=torch.int64), counts.cumsum(0)[:-1]])
    syms, _ = rans.decode_rows(
        states, torch.as_tensor(freqs), words, off, counts, torch.as_tensor(lens), k
    )
    for i, ln in enumerate(lens):
        np.testing.assert_array_equal(syms[i, :ln].numpy(), sym[i, :ln])


def test_decode_rows_width_below_longest_row_raises():
    k = 5
    sym, freqs, lens = _rows([(k * 3 + 1, 40), (k, 7)])
    states, words, counts = rans.encode_rows(
        torch.as_tensor(sym).to(torch.int16), torch.as_tensor(freqs), k
    )
    off = torch.cat([torch.zeros(1, dtype=torch.int64), counts.cumsum(0)[:-1]])
    args = (states, torch.as_tensor(freqs), words, off, counts, torch.as_tensor(lens))
    wide, _ = rans.decode_rows(*args, k, cols=-(-max(lens) // k) * k + k)
    assert wide.shape[1] == -(-max(lens) // k) * k + k and not wide[:, max(lens):].any()
    with pytest.raises(ValueError, match="cols"):
        rans.decode_rows(*args, k, cols=-(-max(lens) // k) * k - 1)


def _streams():
    return {
        "empty": np.zeros(0, dtype=np.int64),
        "one_symbol": np.array([-42], dtype=np.int64),
        "sub_k": _RNG.integers(-100, 100, 63),
        "exactly_k": _RNG.integers(-100, 100, 64),
        "constant": np.full(300, 7, dtype=np.int64),
        "single_plane": _RNG.integers(-64, 64, 1000),
        "two_planes_even_median": _RNG.integers(-3000, 5000, 1024),
        "odd_negative_median": _RNG.integers(-9, 2, 777),
        "eight_plane_extremes": np.concatenate(
            [np.array([0, 1, -1, 2**62, -(2**62), 2**63 - 1, -(2**63) + 1]),
             _RNG.integers(-(2**45), 2**45, 500)]
        ),
        "gaussian": np.round(_RNG.standard_normal(5000) * 200),
    }


@pytest.mark.parametrize("name", sorted(_streams()))
def test_encode_ints_bytes_identical(name):
    q = np.asarray(_streams()[name], dtype=np.int64)
    want = ref_entropy.encode_ints(q, backend="rans")
    got = entropy.encode_ints(torch.as_tensor(q), backend="rans")
    assert got == want
    back = entropy.decode_ints(want, device="cpu")
    np.testing.assert_array_equal(back.numpy(), ref_entropy.decode_ints(want))


def test_encode_ints_batch_rect_and_mixed_lengths():
    s = _streams()
    names = sorted(n for n in s if n != "eight_plane_extremes")
    qs = [np.asarray(s[n], dtype=np.int64) for n in names]
    want = [ref_entropy.encode_ints(q, backend="rans") for q in qs]
    got = entropy.encode_ints_batch([torch.as_tensor(q) for q in qs], backend="rans")
    assert got == want
    rect = np.stack([_RNG.integers(-500, 500, 700) for _ in range(5)])
    assert entropy.encode_ints_batch(
        torch.as_tensor(rect), backend="rans"
    ) == ref_entropy.encode_ints_batch(
        rect, backend="rans"
    )
    back = entropy.decode_ints_batch(got, device="cpu")
    for q, b in zip(qs, back):
        np.testing.assert_array_equal(b.numpy(), q)


def test_normalize_freqs_rows_match_reference():
    counts = np.zeros((6, 256), dtype=np.int64)
    counts[0, :3] = [1, 1, 1]  # surplus spread round-robin
    counts[1, :] = 1  # 256 symbols, exact
    counts[2, 0] = 10**9  # one symbol
    counts[3, :200] = _RNG.integers(1, 5, 200)
    counts[3, 200] = 10**6  # deficit: steal from the big one
    counts[4, ::3] = _RNG.integers(0, 1000, 86)
    want = ref_entropy._rans_normalize_freqs_rows(counts)
    got = entropy._rans_normalize_freqs_rows(torch.as_tensor(counts))
    np.testing.assert_array_equal(got.numpy(), want)


def test_other_backends_and_tags_name_the_later_slice():
    """Every backend of the reference is ported now: each encodes to the
    reference's bytes and each tag decodes; an unknown name or tag raises."""
    q = torch.arange(10)
    for backend in ("best", "zstd", "raw", "bitpack", "rc"):
        if backend == "zstd" and "zstd" not in entropy.available_backends():
            continue
        blob = ref_entropy.encode_ints(np.arange(10), backend=backend)
        assert entropy.encode_ints(q, backend=backend) == blob
        assert torch.equal(entropy.decode_ints(blob, device="cpu"), q)
    with pytest.raises(ValueError, match="unknown backend"):
        entropy.encode_ints(q, backend="lz4")
    blob = ref_entropy.encode_ints(np.arange(10), backend="raw")
    with pytest.raises(FormatError):
        entropy.decode_ints(bytes([99]) + blob[1:], device="cpu")


def test_corrupt_table_and_short_words_raise():
    blob = bytearray(ref_entropy.encode_ints(_RNG.integers(-50, 50, 600), backend="rans"))
    bad = bytearray(blob)
    bad[1 + 18 + 32] ^= 0x01  # first present freq: the table no longer sums to M
    with pytest.raises(CorruptFrameError):
        entropy.decode_ints(bytes(bad), device="cpu")
    with pytest.raises(ValueError):
        entropy.decode_ints(bytes(blob[:-6]), device="cpu")
    # a consistent but shortened word stream: the decoder runs out of words
    npres = int(np.unpackbits(np.frombuffer(bytes(blob[19:51]), np.uint8)).sum())
    at = 1 + 18 + 32 + 2 * npres + 4 * 64
    (nwords,) = struct.unpack_from("<I", blob, at)
    short = bytes(blob[:at]) + struct.pack("<I", nwords - 5) + bytes(blob[at + 4 : -10])
    with pytest.raises(CorruptFrameError, match="ran out"):
        entropy.decode_ints(short, device="cpu")


def test_wrappers_take_plain_versions_on_cpu():
    sym, freqs, lens = _rows([(130, 9)])
    before = dict(ops.launches)
    rans.encode_rows(torch.as_tensor(sym).to(torch.int16), torch.as_tensor(freqs), 64)
    assert dict(ops.launches) == before


MIXED = {
    "empty": np.zeros(0, dtype=np.int64),
    "k1": np.array([5], dtype=np.int64),
    "k17": _RNG.integers(-9, 9, 17),
    "k33_two_planes": _RNG.integers(-3000, 3000, 33),
    "k64_one_plane": _RNG.integers(-50, 50, 900),
    "k64_eight_planes": np.concatenate(
        [np.array([2**62, -(2**62)]), _RNG.integers(-(2**45), 2**45, 300)]),
    "k17_again": _RNG.integers(-200, 200, 17),
    "raw": np.arange(10, dtype=np.int64),
}


def _mixed_blobs() -> list[bytes]:
    return [ref_entropy.encode_ints(q, backend="raw" if name == "raw" else "rans")
            for name, q in MIXED.items()]


def test_decode_ints_batch_mixed_lanes_planes_and_empty(monkeypatch):
    """Streams of 0, 1, 17, 33 and 64 lanes, 1 to 8 planes and a host
    backend in one batch: each equals the reference's ``decode_ints`` of its
    blob, with one decoder launch per lane count (the empty stream has
    k = 1)."""
    blobs = _mixed_blobs()
    lanes, orig = [], rans.decode_rows

    def counting(*args, **kwargs):
        lanes.append(args[6])
        return orig(*args, **kwargs)

    monkeypatch.setattr(rans, "decode_rows", counting)
    got = entropy.decode_ints_batch(blobs, device="cpu")
    assert sorted(lanes) == sorted({b[18] for b in blobs if b[0] == 3})
    assert len(got) == len(blobs)
    for g, blob in zip(got, blobs):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), ref_entropy.decode_ints(blob))


def test_decode_ints_until_error_stops_where_a_loop_would():
    blobs = _mixed_blobs()
    good = blobs[4]  # 900 symbols, 64 lanes
    npres = int(np.unpackbits(np.frombuffer(good[19:51], np.uint8)).sum())
    at = 1 + 18 + 32 + 2 * npres + 4 * 64
    (nwords,) = struct.unpack_from("<I", good, at)
    short = good[:at] + struct.pack("<I", nwords - 5) + good[at + 4 : -10]
    out, exc = entropy.decode_ints_until_error(blobs[:3] + [short, good[:9], good], "cpu")
    assert len(out) == 3 and isinstance(exc, CorruptFrameError) and "ran out" in str(exc)
    out, exc = entropy.decode_ints_until_error([good, good[:9], short], "cpu")
    assert len(out) == 1 and type(exc).__name__ == "TruncatedArchiveError"
    # a stream of the wrong length ends the batch after itself
    out, exc = entropy.decode_ints_until_error([good, blobs[3], short], "cpu", n=900)
    assert exc is None and [q.numel() for q in out] == [900, 33]
    with pytest.raises(CorruptFrameError, match="ran out"):
        entropy.decode_ints_batch([good, short], device="cpu")
