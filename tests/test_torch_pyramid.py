"""The port's ``pyramid_quant`` and ``pyramid_reconstruct`` (their plain
torch versions, which the wrappers run on CPU tensors) against the
reference on the CPU.

Each case mirrors ``tests/test_kernels.py`` (its shapes, layer counts,
ragged lengths, the clip at qmax and prefix refinement) and holds the port
to both ``repro.kernels.ops.*`` (the Pallas kernels in interpret mode) and
the oracles ``repro.kernels.ref.*_ref``:

* qs array-equal;
* err and the reconstruction within atol 2e-6 at the reference test's
  scale (standard normal data), the bound of ``tests/test_kernels.py``:
  XLA's CPU code contracts some multiply-adds that the port keeps apart,
  and the oracle of the reconstruction sums the layers before it adds the
  line, so the last bits differ;
* bit-identical, in float32 and float64, to a numpy step-by-step
  emulation of the Pallas kernels' order (numpy does not fuse), which is
  the order of the CUDA kernels.

The CUDA kernels are held to the plain versions in ``tests/test_torch_cuda.py``.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as kref

from repro_torch.kernels import dequant as DQ
from repro_torch.kernels import ops
from repro_torch.kernels import residual_quant as RQ

STEPS = [0.5, 0.05, 0.005]
ATOL = 2e-6  # tests/test_kernels.py's bound for err and the reconstruction


def _rows(seed: int, m: int, n: int, dtype=np.float32):
    """The reference test's inputs: standard normal x, a line per row."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, n)).astype(dtype)
    theta = rng.standard_normal((m, 1)).astype(dtype)
    slope = (rng.standard_normal((m, 1)) * 0.01).astype(dtype)
    return x, theta, slope


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _steps(steps):
    """float64, so the wrapper rounds each step to x's dtype once, as numpy
    and the reference do."""
    return torch.tensor(steps, dtype=torch.float64)


def _port_quant(x, theta, slope, steps, qmax=127, lengths=None):
    before = dict(ops.launches)
    ln = None if lengths is None else torch.as_tensor(lengths, dtype=torch.int32)
    qs, err = ops.pyramid_quant(*_t(x, theta, slope), _steps(steps), qmax, ln)
    assert ops.launches == before  # a CPU tensor takes the plain version
    assert qs.dtype == torch.int32 and err.dtype == torch.from_numpy(x).dtype
    return qs.numpy(), err.numpy()


def _port_recon(qs, theta, slope, steps):
    before = dict(ops.launches)
    out = ops.pyramid_reconstruct(*_t(qs, theta, slope), _steps(steps))
    assert ops.launches == before
    return out.numpy()


def _np_quant(x, theta, slope, steps, qmax=127, lengths=None):
    """The Pallas kernel's order, one numpy op at a time."""
    dt = x.dtype
    n = x.shape[1]
    t = np.arange(n, dtype=dt)[None, :]
    e = x - (theta + slope * t)
    qs = []
    for st in np.asarray(steps, dt):
        q = np.clip(np.round(e / st), -qmax, qmax)
        e = e - q * st
        qs.append(q.astype(np.int32))
    qs = np.stack(qs)
    if lengths is not None:
        pad = t >= np.asarray(lengths)[:, None]
        qs[:, pad] = 0
        e = np.where(pad, dt.type(0.0), e)
    return qs, e


def _np_recon(qs, theta, slope, steps):
    dt = theta.dtype
    t = np.arange(qs.shape[2], dtype=dt)[None, :]
    acc = theta + slope * t
    for q, st in zip(qs, np.asarray(steps, dt)):
        acc = acc + q.astype(dt) * st
    return acc


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int64 if a.dtype == np.float64 else np.int32)


def _reference_quant(x, theta, slope, steps, qmax=127, lengths=None):
    args = [jnp.asarray(a) for a in (x, theta, slope, np.asarray(steps, x.dtype))]
    ln = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    return [tuple(np.asarray(a) for a in f(*args, qmax=qmax, lengths=ln))
            for f in (rops.pyramid_quant, kref.pyramid_quant_ref)]


def _reference_recon(qs, theta, slope, steps):
    args = [jnp.asarray(a) for a in (qs, theta, slope, np.asarray(steps, theta.dtype))]
    return [np.asarray(f(*args)) for f in (rops.pyramid_reconstruct,
                                           kref.pyramid_reconstruct_ref)]


# ------------------------------------------------------------ pyramid_quant
@pytest.mark.parametrize("m,n", [(8, 128), (32, 256), (5, 384)])
@pytest.mark.parametrize("num_layers", [1, 3])
def test_pyramid_quant_matches_pallas_interpret_and_ref(m, n, num_layers):
    x, theta, slope = _rows(m * n + num_layers, m, n)
    steps = STEPS[:num_layers]
    qs, err = _port_quant(x, theta, slope, steps)
    assert qs.shape == (num_layers, m, n) and err.shape == (m, n)
    for qs_r, err_r in _reference_quant(x, theta, slope, steps):
        np.testing.assert_array_equal(qs, qs_r)
        np.testing.assert_allclose(err, err_r, rtol=0, atol=ATOL)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("ragged", [False, True])
def test_pyramid_quant_is_the_kernels_order_bit_for_bit(dtype, ragged):
    """The exact anchor: the plain version equals the numpy emulation of
    the kernel's order, bit for bit, data scaled x3 so that layer 0 rounds
    at many ties' neighbours and some rows clip."""
    m, n = 64, 512
    x, theta, slope = _rows(7, m, n, dtype)
    x = x * dtype(3)
    lengths = np.random.default_rng(8).integers(0, n + 1, m) if ragged else None
    qs, err = _port_quant(x, theta, slope, STEPS, 16, lengths)
    qs_n, err_n = _np_quant(x, theta, slope, STEPS, 16, lengths)
    np.testing.assert_array_equal(qs, qs_n)
    np.testing.assert_array_equal(_bits(err), _bits(err_n))
    assert (np.abs(qs[0]) == 16).any()  # the clip is exercised


def test_pyramid_quant_ragged_tails_inert():
    m, n = 6, 256
    x = np.random.default_rng(5).standard_normal((m, n)).astype(np.float32)
    theta = np.zeros((m, 1), np.float32)
    slope = np.zeros((m, 1), np.float32)
    steps = [0.5, 0.05]
    lengths = [n, 0, 17, 100, 1, 255]
    qs, err = _port_quant(x, theta, slope, steps, lengths=lengths)
    for qs_r, err_r in _reference_quant(x, theta, slope, steps, lengths=lengths):
        np.testing.assert_array_equal(qs, qs_r)
        np.testing.assert_allclose(err, err_r, rtol=0, atol=ATOL)
    pad = np.arange(n)[None, :] >= np.asarray(lengths)[:, None]
    assert (qs[:, pad] == 0).all()
    assert (_bits(err[pad]) == 0).all()  # +0.0, not -0.0
    assert (qs[:, ~pad] != 0).any()


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_pyramid_quant_clips_at_qmax(sign):
    """Huge residuals saturate at +-qmax on every layer, and err carries
    the clipped mass (the reference test's atol 1e-5 on a value near 100)."""
    m, n = 8, 128
    x = np.full((m, n), 100.0 * sign, np.float32)
    zeros = np.zeros((m, 1), np.float32)
    steps = [0.01, 0.001]
    qs, err = _port_quant(x, zeros, zeros, steps, qmax=127)
    assert (qs == 127 * sign).all()
    want = np.float32(100.0 * sign) - np.float32(127 * sign) * np.float32(0.01)
    want = want - np.float32(127 * sign) * np.float32(0.001)
    np.testing.assert_allclose(err, want, rtol=0, atol=1e-5)
    for qs_r, err_r in _reference_quant(x, zeros, zeros, steps, qmax=127):
        np.testing.assert_array_equal(qs, qs_r)
        np.testing.assert_allclose(err, err_r, rtol=0, atol=1e-5)


# ------------------------------------------------------------ pyramid_reconstruct
@pytest.mark.parametrize("m,n", [(8, 128), (64, 256), (3, 640)])
@pytest.mark.parametrize("num_layers", [1, 2, 3])
def test_pyramid_reconstruct_matches_pallas_interpret_and_ref(m, n, num_layers):
    """On the ladder of standard normal rows, the reference test's scale."""
    x, theta, slope = _rows(m + n + num_layers, m, n)
    steps = STEPS[:num_layers]
    qs, _ = _np_quant(x, theta, slope, steps)
    got = _port_recon(qs, theta, slope, steps)
    assert got.shape == (m, n) and got.dtype == np.float32
    for want in _reference_recon(qs, theta, slope, steps):
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(_bits(got), _bits(_np_recon(qs, theta, slope, steps)))


def test_pyramid_reconstruct_prefix_refines():
    """Each layer prefix tightens the reconstruction to that layer's
    step/2 (no clipping at qmax 32767), the port matches the JAX kernel and
    the oracle at every prefix, bit for bit the numpy emulation in float32
    and float64, and the full stack leaves exactly err."""
    m, n = 16, 256
    x, theta, slope = _rows(16, m, n)
    qs, err = _port_quant(x, theta, slope, STEPS, qmax=32767)
    prev = np.inf
    for k in range(3):
        xh = _port_recon(qs[: k + 1], theta, slope, STEPS[: k + 1])
        for want in _reference_recon(qs[: k + 1], theta, slope, STEPS[: k + 1]):
            np.testing.assert_allclose(xh, want, rtol=0, atol=ATOL)
        np.testing.assert_array_equal(
            _bits(xh), _bits(_np_recon(qs[: k + 1], theta, slope, STEPS[: k + 1])))
        worst = np.max(np.abs(xh - x))
        assert worst <= STEPS[k] / 2 + 1e-5
        assert worst <= prev
        prev = worst
    np.testing.assert_allclose(x - xh, err, rtol=0, atol=1e-5)
    x64, th64, sl64 = (a.astype(np.float64) for a in (x, theta, slope))
    qs64, err64 = _port_quant(x64, th64, sl64, STEPS, qmax=32767)
    xh64 = _port_recon(qs64, th64, sl64, STEPS)
    np.testing.assert_array_equal(_bits(xh64), _bits(_np_recon(qs64, th64, sl64, STEPS)))
    np.testing.assert_allclose(x64 - xh64, err64, rtol=0, atol=1e-12)


# ------------------------------------------------------------ the surface
def test_reference_names_and_argument_orders():
    """``ops`` takes the reference's arguments in its order and defaults,
    without ``force_ref`` (the tensor's device picks the route)."""
    for name in ("interval_stats", "pyramid_quant", "pyramid_reconstruct"):
        want = [(p.name, p.default) for p in inspect.signature(getattr(rops, name)).parameters
                .values() if p.name != "force_ref"]
        got = [(p.name, p.default) for p in inspect.signature(getattr(ops, name)).parameters
               .values()]
        assert got == want, name


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros((4, 8))
    th = torch.zeros((4, 1))
    with pytest.raises(TypeError, match="float32/float64"):
        ops.pyramid_quant(x.to(torch.bfloat16), th, th, [0.5])
    with pytest.raises(ValueError, match="theta"):
        ops.pyramid_quant(x, th.double(), th, [0.5])
    with pytest.raises(ValueError, match="slope"):
        RQ.pyramid_quant_plain(x, th, torch.zeros((3, 1)), [0.5])
    qs = torch.zeros((2, 4, 8), dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        ops.pyramid_reconstruct(qs.to(torch.int16), th, th, [0.5, 0.05])
    with pytest.raises(ValueError, match="2 layers"):
        DQ.pyramid_reconstruct_plain(qs, th, th, [0.5])
    with pytest.raises(TypeError, match="float32/float64"):
        ops.pyramid_reconstruct(qs, th.half(), th.half(), [0.5, 0.05])
