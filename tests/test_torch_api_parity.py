"""The public methods and parameters the port gained to match the
reference, each held to the reference through the same positional call,
on the CPU:

* ``CompressedSeries.size_at`` / ``total_nbytes`` and
  ``ResidualPyramid.prefix_nbytes`` / ``nbytes``: equal for every tier of
  the golden containers and of a seeded ragged batch;
* ``Base.k`` and ``Base.predictions()`` (a float64 host array), bit for bit;
* ``SegmentTable.ends()``, a method as in the reference;
* ``ShrinkCodec.compress_batch(values, eps_targets, decimals, semantics,
  lengths, max_buckets)``, ``extract_semantics_batch(values, config,
  chunk, lengths)`` and ``fluctuation_table(values, delta_global, config,
  lengths)``: the reference's positions bind the same arguments;
* ``ops.rans_encode_rows(sym_mat, freqs, route)`` and
  ``ops.rans_decode_rows(states, freqs, words, n, route)`` on numpy rows;
* ``dequantize_cache(q, cfg)`` and ``Model.init(key)``.
"""
import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro import configs as RC
from repro.core import entropy as ref_entropy
from repro.core import jaxshrink as J
from repro.core import phases as ref_phases
from repro.core import segment_algebra as RA
from repro.core import semantics as ref_sem
from repro.core import serialize as ref_serialize
from repro.kernels import rans as ref_rans
from repro.models import build_model as ref_build
from repro.serving import kvcache as ref_kv

import repro_torch.core as P
from repro_torch import convert
from repro_torch import configs as PC
from repro_torch.core import phases as port_phases
from repro_torch.core import segment_algebra as PA
from repro_torch.core import semantics as port_sem
from repro_torch.core import tensorshrink as T
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.serving import kvcache

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
_spec = importlib.util.spec_from_file_location("golden_regen", GOLDEN / "regen.py")
golden = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(golden)


def _golden_series() -> list:
    """(reference, port) CompressedSeries of every golden frame."""
    out = [(R.cs_from_bytes(b), P.cs_from_bytes(b)) for b in (
        golden.GOLDEN_SHRK.read_bytes(), golden.GOLDEN_PYRAMID.read_bytes())]
    for path in (golden.GOLDEN_SHRKS, golden.GOLDEN_RAGGED):
        blob = path.read_bytes()
        metas, _ = ref_serialize.parse_framed_container(blob)
        for m in metas:
            payload = ref_serialize.frame_payload(blob, m)
            out.append((R.cs_from_bytes(payload), P.cs_from_bytes(payload)))
    return out


def _ragged_batch():
    rng = np.random.default_rng(21)
    arrs = [np.round(np.cumsum(rng.standard_normal(n)) * 0.1, 4) for n in (900, 1, 0, 2500, 37)]
    tiers = [1e-1, 1e-2, 0.0]
    ref = R.ShrinkCodec.from_fraction(np.concatenate(arrs), frac=0.05, backend="rans")
    port = P.ShrinkCodec(P.ShrinkConfig(**dataclasses.asdict(ref.config)), backend="rans",
                         device="cpu")
    return ref.compress_batch(arrs, tiers, 4), port.compress_batch(arrs, tiers, 4), tiers


def test_size_at_and_nbytes_equal_reference():
    pairs = _golden_series()
    ref_b, port_b, tiers = _ragged_batch()
    pairs += list(zip(ref_b, port_b))
    assert len(pairs) > 10
    for r, p in pairs:
        assert p.total_nbytes() == r.total_nbytes()
        assert p.pyramid.nbytes() == r.pyramid.nbytes()
        for k in range(-1, len(r.pyramid.layers)):
            assert p.pyramid.prefix_nbytes(k) == r.pyramid.prefix_nbytes(k)
        for eps in [*r.tiers(), *tiers, r.eps_b_practical, 2 * r.eps_b_practical + 1.0]:
            try:
                want = r.size_at(eps)
            except ValueError as e:
                with pytest.raises(type(e)):
                    p.size_at(eps)
                continue
            assert p.size_at(eps) == want


def test_base_k_and_predictions_bit_identical():
    for r, p in _golden_series()[:6]:
        assert p.base.k == r.base.k
        got, want = p.base.predictions(), r.base.predictions()
        assert isinstance(got, np.ndarray) and got.dtype == np.float64
        assert np.array_equal(got.view(np.int64), want.view(np.int64))
        assert np.array_equal(got, P.base_predictions(p.base, "cpu").numpy())


def test_segment_table_ends_is_a_method():
    for r, p in _golden_series()[:4]:
        rt, pt = RA.segment_table(r.base), PA.segment_table(p.base, "cpu")
        assert np.array_equal(pt.ends().numpy(), rt.ends())
        # the constructor takes the reference's fields, and only those
        assert [f.name for f in dataclasses.fields(pt) if f.init] == \
            [f.name for f in dataclasses.fields(rt)]


def _walks(seed: int, s: int, t: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.round(np.cumsum(rng.standard_normal((s, t)), axis=1) * 0.1, 4)


def test_compress_batch_binds_the_reference_positions():
    v = _walks(3, 4, 700)
    lengths = np.array([700, 5, 0, 300])
    ref = R.ShrinkCodec.from_fraction(v.reshape(-1), frac=0.05, backend="rans")
    port = P.ShrinkCodec(P.ShrinkConfig(**dataclasses.asdict(ref.config)), backend="rans",
                         device="cpu")
    for args in ((v, [1e-2, 0.0], 4, "auto", lengths, 2), (v, [1e-2], None, "numpy", None)):
        want = [R.cs_to_bytes(cs) for cs in ref.compress_batch(*args)]
        assert [P.cs_to_bytes(cs) for cs in port.compress_batch(*args)] == want


def test_extract_semantics_batch_and_fluctuation_table_bind_the_reference_positions():
    v = _walks(4, 3, 500)
    lengths = np.array([500, 17, 260])
    rc, pc = R.ShrinkConfig(eps_b=0.3, lam=1e-4), P.ShrinkConfig(eps_b=0.3, lam=1e-4)
    for chunk, ln in ((64, lengths), (256, None)):
        want = ref_sem.extract_semantics_batch(v, rc, chunk, ln)
        got = port_sem.extract_semantics_batch(torch.as_tensor(v), pc, chunk, ln)
        assert [[(s.t0, s.length, s.level, s.theta) for s in row] for row in got] == \
            [[(s.t0, s.length, s.level, s.theta) for s in row] for row in want]
    dg = np.array([float(r[: n].max() - r[: n].min()) for r, n in zip(v, lengths)])
    lv_r, eps_r = ref_phases.fluctuation_table(v, dg, rc, lengths)
    lv_p, eps_p = port_phases.fluctuation_table(torch.as_tensor(v), torch.as_tensor(dg), pc,
                                                lengths)
    for n, (a, b, c, d) in enumerate(zip(lv_p.numpy(), lv_r, eps_p.numpy(), eps_r)):
        ln = lengths[n]
        np.testing.assert_array_equal(a[:ln], b[:ln])
        np.testing.assert_array_equal(c[:ln], d[:ln])


@pytest.mark.parametrize("spec", [[(64, 16)], [(200, 8), (64, 250), (130, 2)], [(3000, 200)]])
def test_ops_rans_rows_take_the_reference_contract(spec):
    rng = np.random.default_rng(len(spec))
    streams = [rng.integers(0, hi, n) for n, hi in spec]
    cols = max(s.size for s in streams)
    sym = np.full((len(streams), cols), 256, dtype=np.uint16)
    freqs = np.empty((len(streams), 256), dtype=np.int64)
    for i, s in enumerate(streams):
        sym[i, : s.size] = s
        freqs[i] = ref_entropy._rans_normalize_freqs(np.bincount(s, minlength=256))
    st_r, w_r = ref_rans.encode_rows(sym, freqs, "xla")
    st_p, w_p = ops.rans_encode_rows(sym, freqs, "xla", device="cpu")
    assert st_p.dtype == st_r.dtype and np.array_equal(st_p, st_r)
    assert len(w_p) == len(w_r) and all(
        a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(w_p, w_r))
    n = min(s.size for s in streams)
    want = ref_rans.decode_rows(st_r, freqs, w_r, n, "xla")
    got = ops.rans_decode_rows(st_p, freqs, w_p, n, "xla", device="cpu")
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_dequantize_cache_takes_a_config_in_the_reference_place():
    rng = np.random.default_rng(6)
    shape = (2, 40, 4, 32)
    k = np.asarray(jnp.asarray(rng.standard_normal(shape), jnp.bfloat16))
    v = np.asarray(jnp.asarray(rng.standard_normal(shape) * 3, jnp.bfloat16))
    kpos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40)).copy()
    from repro.models.layers import AttnCache as RefAttnCache

    rc = RefAttnCache(jnp.asarray(k), jnp.asarray(v), jnp.asarray(kpos))
    pc = convert.attn_cache_from_reference(k, v, kpos, device="cpu")
    cfg_r, cfg_p = J.TensorCodecConfig(block=128, use_kernel=False), T.TensorCodecConfig(block=128)
    back_r = ref_kv.dequantize_cache(ref_kv.quantize_cache(rc, cfg_r), cfg_r)
    back_p = kvcache.dequantize_cache(kvcache.quantize_cache(pc, cfg_p), cfg_p)
    for name in ("k", "v", "kpos"):
        want = np.asarray(getattr(back_r, name).astype(jnp.float32))
        np.testing.assert_array_equal(getattr(back_p, name).float().numpy(), want)


def test_model_init_takes_the_key_in_the_reference_place():
    arch = "llama3-8b"
    ref = ref_build(RC.reduced_config(RC.ARCHS[arch])).init(jax.random.PRNGKey(0))
    port = build_model(PC.reduced_config(PC.ARCHS[arch]))
    a, b = port.init(3, device="cpu"), port.init(key=3, device="cpu")
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    lr = jax.tree_util.tree_leaves(ref)
    assert len(la) == len(lr) and all(torch.equal(x, y) for x, y in zip(la, lb))
    assert [tuple(x.shape) for x in la] == [tuple(x.shape) for x in lr]
    assert not torch.equal(la[0], jax.tree_util.tree_leaves(port.init(4, device="cpu"))[0])
