"""Parity of the port's tensor codec (``core.tensorshrink``), its two
kernels' plain versions and the KV-cache store with the reference, on the
CPU.

The reference has two CPU routes: its Pallas kernels in interpret mode
(``use_kernel=True``, jitted, where XLA fuses ``a + b * c`` into an FMA)
and its jnp oracles (``use_kernel=False``, op by op, no FMA).  The port
computes the Pallas kernel's form, ``r * (1 / step)``, where the oracle
divides, ``r / step``, and never fuses.  So:

* ``q``, ``theta``, ``slope`` and ``step`` equal the interpret route bit
  for bit; ``theta``, ``slope`` and ``step`` equal the oracle route bit for
  bit, and ``q`` does wherever the reference's two routes agree (on the
  seeded inputs here they differ at 0 to 2 of 262,144 elements, where
  ``r / step`` and ``r * (1 / step)`` round apart);
* ``err`` and ``decompress_tensor`` equal the oracle route bit for bit
  wherever ``q`` does, and are within ``4 * 2**-23 * max|x|`` of the
  interpret route (its FMA; measured up to 0.67 of that unit on these
  inputs).
"""
import jax  # noqa: F401  (parity suites import both packages)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import jaxshrink as J
from repro.kernels import ref as ref_k
from repro.kernels.dequant import dequant_reconstruct_pallas
from repro.kernels.residual_quant import residual_quant_pallas
from repro.models.layers import AttnCache as RefAttnCache
from repro.serving import kvcache as ref_kv

from repro_torch import convert
from repro_torch.core.errors import ConfigError
from repro_torch.core import tensorshrink as T
from repro_torch.kernels import dequant as DQ
from repro_torch.kernels import ops
from repro_torch.kernels import residual_quant as RQ
from repro_torch.models.layers import AttnCache
from repro_torch.serving import kvcache

ULP = 2.0**-23


def _kv_like(seed: int, shape=(4, 64, 8, 128)) -> np.ndarray:
    """Normal values with a log-normal scale per channel (the last axis), as
    in real K caches: some channels are much larger than others."""
    rng = np.random.default_rng(seed)
    scale = np.exp(rng.standard_normal(shape[-1]) * 0.7)
    return np.asarray(jnp.asarray(rng.standard_normal(shape) * scale, jnp.bfloat16))


def _both(x_bf16: np.ndarray):
    xj = jnp.asarray(x_bf16)
    xt = torch.from_numpy(x_bf16.astype(np.float32)).to(torch.bfloat16)
    return xj, xt


def _ref_fields(c) -> list[np.ndarray]:
    return [
        np.asarray(c.q), np.asarray(c.theta.astype(jnp.float32)),
        np.asarray(c.slope.astype(jnp.float32)), np.asarray(c.step),
    ]


def _port_fields(c) -> list[np.ndarray]:
    return [c.q.numpy(), c.theta.float().numpy(), c.slope.float().numpy(), c.step.numpy()]


@pytest.mark.parametrize("block", [128, 256])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compress_decompress_against_both_reference_routes(seed, block):
    x = _kv_like(seed)
    xj, xt = _both(x)
    scale = float(np.abs(x.astype(np.float32)).max())
    routes = {}
    for uk in (True, False):
        cfg = J.TensorCodecConfig(block=block, use_kernel=uk)
        c, e = J.compress_tensor(xj, cfg)
        routes[uk] = (c, np.asarray(e), np.asarray(J.decompress_tensor(c, cfg)))
    ops.reset_launches()
    c, e = T.compress_tensor(xt, T.TensorCodecConfig(block=block))
    d = T.decompress_tensor(c)
    assert ops.launches["residual_quant"] == ops.launches["dequant"] == 0  # plain on the CPU
    assert ops.launches["base_fit"] == 0
    assert c.q.dtype == torch.int8 and c.theta.dtype == c.slope.dtype == torch.bfloat16
    assert c.step.dtype == torch.float32 and d.dtype == torch.float32 and d.shape == xt.shape
    mine = _port_fields(c)
    # the interpret route: q, theta, slope, step bit for bit
    for a, b in zip(_ref_fields(routes[True][0]), mine):
        np.testing.assert_array_equal(b, a)
    # the oracle route: theta, slope, step bit for bit; q where its routes agree
    ref_q, *ref_rest = _ref_fields(routes[False][0])
    for a, b in zip(ref_rest, mine[1:]):
        np.testing.assert_array_equal(b, a)
    routes_differ = ref_q != np.asarray(routes[True][0].q)
    assert routes_differ.sum() <= 2
    np.testing.assert_array_equal(mine[0] != ref_q, routes_differ)
    same = ~routes_differ.reshape(-1)[: x.size]
    np.testing.assert_array_equal(e.numpy()[same], routes[False][1][same])
    np.testing.assert_array_equal(d.numpy().reshape(-1)[same], routes[False][2].reshape(-1)[same])
    # the interpret route: within its FMA's rounding
    assert np.abs(e.numpy() - routes[True][1]).max() <= 4 * ULP * scale
    assert np.abs(d.numpy() - routes[True][2]).max() <= 4 * ULP * scale
    assert c.wire_bits() == routes[True][0].wire_bits()


def test_external_step_and_wide_bits():
    x = _kv_like(3, (2, 16, 4, 64))
    xj, xt = _both(x)
    cfg_r = J.TensorCodecConfig(block=128, bits=12, use_kernel=True)
    c_r, _ = J.compress_tensor(xj, cfg_r)
    step = np.full((x.size // 128, 1), 0.01, np.float32)
    c_r2, _ = J.compress_tensor(xj, cfg_r, step=jnp.asarray(step))
    c, _ = T.compress_tensor(xt, T.TensorCodecConfig(block=128, bits=12))
    c2, _ = T.compress_tensor(xt, T.TensorCodecConfig(block=128, bits=12), step=torch.as_tensor(step))
    assert c.q.dtype == torch.int16
    for ref_c, port_c in ((c_r, c), (c_r2, c2)):
        for a, b in zip(_ref_fields(ref_c), _port_fields(port_c)):
            np.testing.assert_array_equal(b, a)


def test_padded_tail_block():
    """A tensor whose size is no multiple of the block: the last block is
    zero-padded and the outputs cut back to the tensor's size."""
    x = _kv_like(4, (3, 7, 5, 9))
    xj, xt = _both(x)
    c_r, e_r = J.compress_tensor(xj, J.TensorCodecConfig(block=128, use_kernel=True))
    c, e = T.compress_tensor(xt, T.TensorCodecConfig(block=128))
    assert c.orig_len == c_r.orig_len == x.size and e.shape == (x.size,)
    for a, b in zip(_ref_fields(c_r), _port_fields(c)):
        np.testing.assert_array_equal(b, a)
    assert T.decompress_tensor(c).shape == x.shape


@pytest.mark.parametrize("m,n", [
    (4103, 256), (13, 128), (40, 100), (5, 20), (21, 300), (13, 256), (45, 256), (13, 32),
    (45, 33),
    # sum(tc * tc) in XLA's order matters from K = 386 on
    (7, 386), (13, 520), (13, 877), (13, 1024),
    # a single row: XLA's vector dot, its own order (kernels/base_fit._dot_single):
    # one chain below 60; 2 accumulators to 63; epilogues of 2, 4, 2 x 3, 8 and
    # 4 x 3 + 1 lanes; unrolled to 17 steps of 32, a loop from 18
    (1, 1), (1, 7), (1, 33), (1, 59), (1, 60), (1, 63), (1, 64), (1, 66), (1, 68), (1, 70),
    (1, 72), (1, 77), (1, 128), (1, 256), (1, 520), (1, 575), (1, 576), (1, 876), (1, 877),
    (1, 1024),
])
def test_linear_base_fit_bit_identical(m, n):
    rng = np.random.default_rng(m * n)
    xb = (rng.standard_normal((m, n)) * np.exp(rng.standard_normal((m, 1)) * 2)).astype(np.float32)
    # rows of signed zeros: the padding zeros of the windowed sum set the sign
    if m > 2:
        xb[1] = -0.0
        xb[2, ::3] = 0.0
        xb[2, 1::3] = -0.0
    th_r, sl_r = J.linear_base_fit(jnp.asarray(xb))
    th_p, sl_p = T.linear_base_fit(torch.from_numpy(xb))
    np.testing.assert_array_equal(th_p.numpy(), np.asarray(th_r))
    np.testing.assert_array_equal(sl_p.numpy(), np.asarray(sl_r))


def _quant_inputs(seed: int, m: int = 96, n: int = 128):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, n)) * 3).astype(np.float32)
    theta = np.array(jnp.asarray(rng.standard_normal((m, 1)), jnp.bfloat16).astype(jnp.float32))
    slope = np.array(jnp.asarray(rng.standard_normal((m, 1)) * 0.01, jnp.bfloat16).astype(jnp.float32))
    step = (rng.random((m, 1)) * 0.05 + 1e-3).astype(np.float32)
    lengths = rng.integers(0, n + 1, m).astype(np.int32)
    return x, theta, slope, step, lengths


@pytest.mark.parametrize("ragged", [False, True])
def test_residual_quant_plain_against_reference(ragged):
    x, theta, slope, step, lengths = _quant_inputs(5)
    ln = lengths if ragged else None
    q_o, e_o = ref_k.residual_quant_ref(*map(jnp.asarray, (x, theta, slope, step)), qmax=127,
                                        lengths=None if ln is None else jnp.asarray(ln))
    q_k, e_k = residual_quant_pallas(*map(jnp.asarray, (x, theta, slope, step)),
                                     lengths=None if ln is None else jnp.asarray(ln), interpret=True)
    q, e = RQ.residual_quant(*map(torch.from_numpy, (x, theta, slope, step)), 127,
                             None if ln is None else torch.from_numpy(ln))
    q_o, e_o, q_k, e_k = map(np.asarray, (q_o, e_o, q_k, e_k))
    assert q.dtype == torch.int32
    np.testing.assert_array_equal(q.numpy(), q_k)
    same = q_o == q_k  # the oracle divides, the kernel multiplies by 1 / step
    np.testing.assert_array_equal(q.numpy()[same], q_o[same])
    np.testing.assert_array_equal(e.numpy()[same], e_o[same])
    assert np.abs(e.numpy() - e_k).max() <= 4 * ULP * float(np.abs(x).max() + 3)
    if ragged:
        pad = np.arange(x.shape[1])[None, :] >= lengths[:, None]
        assert pad.any() and not q.numpy()[pad].any() and not e.numpy()[pad].any()
        np.testing.assert_array_equal(q_o[pad], 0)
    q8, e8 = RQ.residual_quant(*map(torch.from_numpy, (x, theta, slope, step)), 127,
                               out_dtype=torch.int8)
    assert q8.dtype == torch.int8 and torch.equal(q8.int(), RQ.residual_quant_plain(
        *map(torch.from_numpy, (x, theta, slope, step)))[0])


def test_dequant_plain_against_reference():
    x, theta, slope, step, _ = _quant_inputs(6)
    q = np.random.default_rng(6).integers(-127, 128, x.shape).astype(np.int32)
    want = np.asarray(ref_k.dequant_reconstruct_ref(*map(jnp.asarray, (q, theta, slope, step))))
    near = np.asarray(dequant_reconstruct_pallas(*map(jnp.asarray, (q, theta, slope, step))))
    for dt in (torch.int32, torch.int16, torch.int8):
        got = DQ.dequant(torch.from_numpy(q).to(dt), *map(torch.from_numpy, (theta, slope, step)))
        np.testing.assert_array_equal(got.numpy(), want)
    assert np.abs(got.numpy() - near).max() <= 4 * ULP * float(np.abs(want).max())


def test_wrappers_take_plain_versions_on_cpu():
    x, theta, slope, step, _ = _quant_inputs(7, 8, 16)
    args = list(map(torch.from_numpy, (x, theta, slope, step)))
    ops.reset_launches()
    q, _ = ops.residual_quant(*args)
    ops.dequant(q, *args[1:])
    ops.base_fit(args[0])
    assert ops.launches["residual_quant"] == ops.launches["dequant"] == ops.launches["base_fit"] == 0


def _caches(seed: int, prompt: int = 24, groups: int = 3, batch: int = 2):
    rng = np.random.default_rng(seed)
    shape = (groups, batch, prompt, 4, 32)
    k = np.asarray(jnp.asarray(rng.standard_normal(shape), jnp.bfloat16))
    v = np.asarray(jnp.asarray(rng.standard_normal(shape) * 2, jnp.bfloat16))
    kpos = np.broadcast_to(np.arange(prompt, dtype=np.int32), (groups, batch, prompt)).copy()
    tail_k = np.asarray(jnp.asarray(rng.standard_normal((batch, prompt, 4, 32)), jnp.bfloat16))
    ref = {
        "prefix": [],
        "groups": {"pos0": {"self": RefAttnCache(jnp.asarray(k), jnp.asarray(v), jnp.asarray(kpos))}},
        "tail": [{"self": RefAttnCache(jnp.asarray(tail_k), jnp.asarray(tail_k), jnp.asarray(kpos[0]))}],
    }
    port = {
        "prefix": [],
        "groups": {"pos0": {"self": convert.attn_cache_from_reference(k, v, kpos, device="cpu")}},
        "tail": [{"self": convert.attn_cache_from_reference(tail_k, tail_k, kpos[0], device="cpu")}],
    }
    return ref, port


def _np(a) -> np.ndarray:
    return np.asarray(a.astype(jnp.float32)) if a.dtype == jnp.bfloat16 else np.asarray(a)


def test_promote_quantize_dequantize_and_memory_bits_equal_reference():
    ref, port = _caches(8)
    ref_p = ref_kv.promote_caches(ref, 64)
    port_p = kvcache.promote_caches(port, 64)
    for path in (("groups", "pos0", "self"), ("tail", 0, "self")):
        rc, pc = ref_p, port_p
        for key in path:
            rc, pc = rc[key], pc[key]
        assert isinstance(pc, AttnCache)
        for name in ("k", "v", "kpos"):
            np.testing.assert_array_equal(getattr(pc, name).float().numpy(), _np(getattr(rc, name)))
        assert pc.k.dtype == torch.bfloat16 and pc.kpos.dtype == torch.int32
    assert port_p["prefix"] == [] and int(port_p["groups"]["pos0"]["self"].kpos[..., 24:].max()) == -1
    rc, pc = ref_p["groups"]["pos0"]["self"], port_p["groups"]["pos0"]["self"]
    cfg = T.TensorCodecConfig(block=128)
    q_r = ref_kv.quantize_cache(rc, J.TensorCodecConfig(block=128, use_kernel=True))
    q_p = kvcache.quantize_cache(pc, cfg)
    assert q_p.memory_bits() == q_r.memory_bits()
    raw_bits = (pc.k.numel() + pc.v.numel()) * 16 + pc.kpos.numel() * 32
    assert q_p.memory_bits() < raw_bits / 1.7
    for a_r, a_p in ((q_r.k, q_p.k), (q_r.v, q_p.v)):
        for a, b in zip(_ref_fields(a_r), _port_fields(a_p)):
            np.testing.assert_array_equal(b, a)
    back_r = ref_kv.dequantize_cache(q_r, J.TensorCodecConfig(block=128, use_kernel=False))
    back_p = kvcache.dequantize_cache(q_p)
    for name in ("k", "v", "kpos"):
        np.testing.assert_array_equal(getattr(back_p, name).float().numpy(), _np(getattr(back_r, name)))
    assert back_p.k.dtype == torch.bfloat16


def test_convert_round_trip():
    x = _kv_like(9, (2, 8, 4, 64))
    xj, xt = _both(x)
    cfg = J.TensorCodecConfig(block=128, use_kernel=False)
    c_r, _ = J.compress_tensor(xj, cfg)
    c_p = convert.compressed_tensor_from_reference(
        np.asarray(c_r.q), np.asarray(c_r.theta), np.asarray(c_r.slope), np.asarray(c_r.step),
        c_r.orig_len, c_r.shape, device="cpu",
    )
    np.testing.assert_array_equal(T.decompress_tensor(c_p).numpy(), np.asarray(J.decompress_tensor(c_r, cfg)))
    fields = convert.compressed_tensor_to_reference(T.compress_tensor(xt, T.TensorCodecConfig(block=128))[0])
    back = J.CompressedTensor(
        q=jnp.asarray(fields["q"]), theta=jnp.asarray(fields["theta"], jnp.bfloat16),
        slope=jnp.asarray(fields["slope"], jnp.bfloat16), step=jnp.asarray(fields["step"]),
        orig_len=fields["orig_len"], shape=fields["shape"],
    )
    c_p2 = convert.compressed_tensor_from_reference(**fields, device="cpu")
    np.testing.assert_array_equal(
        np.asarray(J.decompress_tensor(back, cfg)), T.decompress_tensor(c_p2).numpy()
    )
    with pytest.raises(ValueError, match="bf16"):
        convert.compressed_tensor_from_reference(
            fields["q"], fields["theta"] + np.float32(1e-3), fields["slope"], fields["step"],
            fields["orig_len"], fields["shape"], device="cpu",
        )


def test_convert_defaults_to_the_card():
    fields = convert.compressed_tensor_to_reference(
        T.compress_tensor(torch.ones(256), T.TensorCodecConfig(block=128))[0]
    )
    kv = np.zeros((1, 2, 4), np.float32)
    kpos = np.arange(2, dtype=np.int32)[None]
    if torch.cuda.is_available():
        assert convert.compressed_tensor_from_reference(**fields).q.is_cuda
        assert convert.attn_cache_from_reference(kv, kv, kpos).k.is_cuda
    else:
        with pytest.raises(ConfigError, match="CUDA"):
            convert.compressed_tensor_from_reference(**fields)
        with pytest.raises(ConfigError, match="CUDA"):
            convert.attn_cache_from_reference(kv, kv, kpos)
