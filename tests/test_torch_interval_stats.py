"""The port's ``interval_stats`` (its plain torch version, which the wrapper
runs on CPU tensors) against the reference on the CPU, bit for bit.

Each case goes through ``repro.kernels.ops.interval_stats`` (the Pallas
kernel in interpret mode, as ``tests/test_kernels.py`` runs it) and the
oracle ``repro.kernels.ref.interval_stats_ref``, in float32, bfloat16 and
float64 (the reference with x64 on).  The function only selects elements,
so every output must equal the reference's bits: NaN windows and windows
that hold both signed zeros, in both orders, included.  The CUDA kernel is
held to the plain version in ``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as kref

from repro_torch.kernels import interval_stats as IS
from repro_torch.kernels import ops

DTYPES = {
    "float32": (np.float32, torch.float32, np.uint32),
    "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16, np.uint16),
    "float64": (np.float64, torch.float64, np.uint64),
}


def _reference(x: np.ndarray, window: int):
    """(Pallas interpret, oracle) outputs as numpy arrays of x's dtype."""
    with jax.enable_x64(x.dtype == np.float64):
        xj = jnp.asarray(x)
        assert xj.dtype == x.dtype
        return [tuple(np.asarray(a) for a in f(xj, window))
                for f in (rops.interval_stats, kref.interval_stats_ref)]


def _port(x: np.ndarray, window: int, tdtype):
    before = dict(ops.launches)
    xt = torch.from_numpy(x.view(np.int16)).view(tdtype) if tdtype == torch.bfloat16 \
        else torch.from_numpy(x)
    out = ops.interval_stats(xt, window)
    assert ops.launches == before  # a CPU tensor takes the plain version
    assert all(o.dtype == tdtype for o in out)
    if tdtype == torch.bfloat16:
        return tuple(o.view(torch.int16).numpy().view(ml_dtypes.bfloat16) for o in out)
    return tuple(o.numpy() for o in out)


def _same_bits(got, want, ubits):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g.view(ubits), w.view(ubits))


def _check(x: np.ndarray, window: int, name: str):
    _, tdtype, ubits = DTYPES[name]
    got = _port(x, window, tdtype)
    for want in _reference(x, window):
        _same_bits(got, want, ubits)


@pytest.mark.parametrize("shape,window", [
    ((128, 128), 16),
    ((512, 256), 64),
    ((1024, 128), 128),
    ((64, 512), 8),
    ((96, 37), 1),
    ((96, 37), 96),
])
@pytest.mark.parametrize("name", list(DTYPES))
def test_matches_pallas_interpret_and_ref(shape, window, name):
    """The reference test's shapes and windows (plus a width that is not a
    multiple of 32, W = 1 and W = T), bit for bit."""
    rng = np.random.default_rng([*shape, window])
    x = rng.standard_normal(shape).astype(DTYPES[name][0])
    _check(x, window, name)


def _specials(npdt) -> np.ndarray:
    """Windows of 4 (columns) that hold NaNs, infinities and both zeros in
    every order; the second window repeats them reversed in time."""
    nan, inf = np.nan, np.inf
    cols = [
        [0.0, -0.0, 1, 2], [-0.0, 0.0, 1, 2], [1, 0.0, -0.0, 2], [1, -0.0, 0.0, 2],
        [0.0, 0.0, -0.0, 3], [-0.0, -0.0, 0.0, 3], [-1, 0.0, -0.0, -2], [0.0, -0.0, -1, -2],
        [-0.0, -0.0, -0.0, -0.0], [0.0, 0.0, 0.0, 0.0], [0.0, 1, 2, -0.0], [-0.0, 1, 2, 0.0],
        [nan, 1, 2, 3], [1, 2, 3, nan], [1, nan, -0.0, 0.0], [nan, nan, 0.0, -0.0],
        [inf, -inf, 0, 1], [-inf, -inf, -inf, -inf], [nan, -inf, inf, 0.0], [5, 5, 5, 5],
    ]
    x = np.array(cols, dtype=np.float64).T
    return np.concatenate([x, x[::-1]], 0).astype(npdt)


@pytest.mark.parametrize("name", list(DTYPES))
def test_nans_and_signed_zeros_match_the_reference(name):
    """NaN propagates, and the min of a window holding both zeros is -0.0
    and its max +0.0 whatever their order, as the reference gives them."""
    x = _specials(DTYPES[name][0])
    _check(x, 4, name)
    mn, mx = _port(x, 4, DTYPES[name][1])
    assert np.signbit(mn[:, :8].astype(np.float32)).all()
    assert not np.signbit(mx[:, :6].astype(np.float32)).any()
    assert np.isnan(mn[:, 12:16].astype(np.float32)).all()


def test_nan_bits():
    """A float32 or float64 NaN keeps its bits (sign and payload, a
    signalling NaN too); a bfloat16 NaN comes out as the quiet NaN with its
    sign, as the reference gives it.  Each window holds one NaN."""
    for npdt, ubits, words in (
        (np.float32, np.uint32, [0xFFC00000, 0x7FC00123, 0x7F800001]),
        (np.float64, np.uint64, [0xFFF8000000000000, 0x7FF8000000000123, 0x7FF0000000000001]),
    ):
        nans = np.array(words, dtype=ubits).view(npdt)
        x = np.tile(np.array([1.0, -2.0, 0.0, 3.0], npdt)[:, None], (1, 3))
        x[1] = nans
        name = "float32" if npdt == np.float32 else "float64"
        _check(x, 4, name)
        mn, mx = _port(x, 4, DTYPES[name][1])
        assert (mn.view(ubits)[0] == nans.view(ubits)).all()
        assert (mx.view(ubits)[0] == nans.view(ubits)).all()
    words = np.array([[0xFFC0, 0x7FC1, 0x7F81], [0x3F80] * 3], np.uint16)
    x = words.view(ml_dtypes.bfloat16)
    _check(x, 2, "bfloat16")
    mn, _ = _port(x, 2, torch.bfloat16)
    assert mn.view(np.uint16)[0].tolist() == [0xFFC0, 0x7FC0, 0x7FC0]


@pytest.mark.parametrize("t,window", [(100, 64), (128, 0), (7, 2)])
def test_rejects_a_ragged_window(t, window):
    x = torch.zeros((t, 128), dtype=torch.float32)
    with pytest.raises(ValueError, match="multiple"):
        ops.interval_stats(x, window)
    with pytest.raises(ValueError, match="multiple"):
        IS.interval_stats_plain(x, window)


def test_rejects_other_dtypes_and_shapes():
    with pytest.raises(TypeError, match="float32"):
        ops.interval_stats(torch.zeros((8, 4), dtype=torch.int32), 4)
    with pytest.raises(TypeError, match="float32"):
        ops.interval_stats(torch.zeros((8, 4), dtype=torch.float16), 4)
    with pytest.raises(ValueError, match=r"x\[T, S\]"):
        ops.interval_stats(torch.zeros(8), 4)


def test_strided_input_and_empty_shapes():
    """A transposed view (the gateway's [S, T] series read time-major) and
    empty shapes give what a contiguous copy gives."""
    rng = np.random.default_rng(4)
    v = torch.from_numpy(rng.standard_normal((5, 64)))
    got = ops.interval_stats(v.T, 16)
    want = ops.interval_stats(v.T.contiguous(), 16)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    for shape, window, out in (((0, 4), 2, (0, 4)), ((8, 0), 4, (2, 0))):
        mn, mx = ops.interval_stats(torch.zeros(shape), window)
        assert mn.shape == mx.shape == out
