"""Parity of the port's streamed ``SHRKS`` containers with the reference,
on the CPU.

* ``ShrinkStreamCodec``: container bytes identical to the reference's in
  the incremental and the deferred scan, under several chunkings, and the
  same bytes for every chunking; ``stats`` equal;
* ``golden_v4.shrks`` rebuilt byte for byte; the golden containers decode
  bit-identically with equal ``routing_metadata``;
* ``KnowledgeBase``: ``to_bytes``, ``merge``, ``release`` and the
  snapshot ids identical;
* corrupt, truncated and foreign containers raise the same typed errors.
"""
import importlib.util
import pathlib

import jax  # noqa: F401
import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import errors as RE
from repro.core import streaming as RS

import repro_torch.core as P
from repro_torch.core import errors as PE
from repro_torch import convert
from repro_torch.core import serialize as PZ
from repro_torch.core import streaming as PS
from repro_torch.core.semantics import global_range

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
_spec = importlib.util.spec_from_file_location("golden_regen", GOLDEN / "regen.py")
golden = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(golden)

TIERS = [1e-2, 1e-3, 0.0]


def _walks(seed: int, s: int, t: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    v = np.cumsum(rng.standard_normal((s, t)) * 0.05, axis=1)
    v += rng.standard_normal((s, t)) * 0.02
    return np.round(v, 4)


def _configs(v):
    cfg = dict(eps_b=0.02 * float(v.max() - v.min()), lam=1e-4)
    return R.ShrinkConfig(**cfg), P.ShrinkConfig(**cfg)


def _stream(mod, cfg, v, mode: str, chunk: int, backend: str, **kw):
    """Interleaved chunk-at-a-time ingest of every series, then finalize."""
    pinned = (float(v.min()), float(v.max()))
    args = dict(eps_targets=TIERS, decimals=4, backend=backend, frame_len=700, **kw)
    if mode == "incremental":
        args["value_range"] = pinned
    elif mode == "deferred_pinned":  # range pinned, L left to each frame
        args.update(value_range=pinned, frame_len=None)
    sc = mod.ShrinkStreamCodec(cfg, **args)
    for c0 in range(0, v.shape[1], chunk):
        for sid in range(v.shape[0]):
            sc.ingest(v[sid, c0 : c0 + chunk], series_id=sid)
    return sc, sc.finalize()


MODES = ["incremental", "deferred", "deferred_pinned"]


@pytest.mark.parametrize("backend", ["rans", "best"])
@pytest.mark.parametrize("mode", MODES)
def test_container_bytes_identical_for_every_chunking(mode, backend):
    v = _walks(0, 3, 2500)
    rcfg, pcfg = _configs(v)
    frames = []
    for chunk in (1 << 20, 333, 97, 1000):
        rsc, want = _stream(RS, rcfg, v, mode, chunk, backend)
        psc, got = _stream(PS, pcfg, v, mode, chunk, backend, device="cpu")
        assert got == want, (mode, chunk)
        assert psc.stats() == rsc.stats()
        assert psc.sealed_frames == rsc.sealed_frames
        assert psc.incremental == (mode == "incremental")
        metas, _ = PZ.parse_framed_container(got)
        frames.append({(m.series_id, m.t_lo, m.t_hi): PZ.frame_payload(got, m)
                       for m in metas})
    # the chunking changes the seal order of the series' frames, no payload byte
    assert all(f == frames[0] for f in frames)


def test_flush_and_reingest_continue_the_sample_range():
    v = _walks(1, 2, 1800)
    rcfg, pcfg = _configs(v)
    out = []
    for mod, cfg, kw in ((RS, rcfg, {}), (PS, pcfg, {"device": "cpu"})):
        sc = mod.ShrinkStreamCodec(cfg, TIERS, decimals=4, backend="rans",
                                   value_range=(float(v.min()), float(v.max())),
                                   frame_len=500, **kw)
        sealed = [sc.ingest(v[0, :650], 0), sc.ingest(v[1, :120], 1), sc.flush(0)]
        sealed += [sc.ingest(v[0, 650:], 0), sc.ingest(v[1, 120:], 1)]
        out.append((sealed, sc.finalize(), sc.sealed_frames))
    assert out[0] == out[1]


def test_golden_shrks_rebuilt_byte_for_byte():
    v = golden.golden_series()
    cfg = P.ShrinkConfig(eps_b=0.05 * float(v.max() - v.min()), lam=1e-3)
    sc = P.ShrinkStreamCodec(
        cfg, eps_targets=golden.EPS_TARGETS, decimals=golden.DECIMALS, backend="rans",
        value_range=global_range(torch.as_tensor(v)), frame_len=golden.FRAME_LEN, device="cpu",
    )
    for lo in range(0, golden.N, 100):
        sc.ingest(v[lo : lo + 100])
    assert sc.finalize() == golden.GOLDEN_SHRKS.read_bytes()


@pytest.mark.parametrize("name", ["golden_v4.shrks", "golden_v4_ragged.shrks",
                                  "golden_v4_ref.shrks"])
def test_golden_containers_decode_bit_identically(name):
    blob = (GOLDEN / name).read_bytes()
    meta = P.routing_metadata(blob)
    assert meta == R.routing_metadata(blob)
    assert P.read_knowledge_base(blob).to_bytes() == R.read_knowledge_base(blob).to_bytes()
    for sid in meta["series_ids"]:
        for eps in (1.0, 1e-2, 0.005, 0.0):
            want = R.decode_series(blob, sid, eps)
            got = P.decode_series(blob, sid, eps, device="cpu").numpy()
            assert np.array_equal(got.view(np.int64), want.view(np.int64)), (sid, eps)
            if want.size > 3:
                lo, hi = want.size // 3, want.size - 1
                part = P.decode_range(blob, sid, lo, hi, eps, device="cpu").numpy()
                assert np.array_equal(part, R.decode_range(blob, sid, lo, hi, eps))


def _kb_pair(seed: int):
    v = _walks(seed, 2, 1600)
    rcfg, pcfg = _configs(_walks(0, 3, 2500))  # one config for both gateways
    rsc, _ = _stream(RS, rcfg, v, "incremental", 400, "rans")
    psc, _ = _stream(PS, pcfg, v, "incremental", 400, "rans", device="cpu")
    return rsc.kb, psc.kb


def test_knowledge_base_bytes_merge_and_release_identical():
    r1, p1 = _kb_pair(3)
    r2, p2 = _kb_pair(4)
    assert p1.to_bytes() == r1.to_bytes()
    assert convert.knowledge_base_from_reference(r1.to_bytes()).to_bytes() == r1.to_bytes()
    assert p1.snapshot_id() == r1.snapshot_id()
    assert p1.canonical() == r1.canonical()
    assert p2.merge(p1) == r2.merge(r1)
    assert p2.to_bytes() == r2.to_bytes()
    assert p2.stats() == r2.stats()
    ids = [0] * p2.entries[0].refs + [len(p2.entries) - 1]  # entry 0 down to 0 refs
    p2.release(ids)
    r2.release(ids)
    assert p2.entries[0].refs == 0
    assert p2.to_bytes() == r2.to_bytes()
    assert p2.snapshot_id() == r2.snapshot_id()
    back = P.KnowledgeBase.from_bytes(p2.to_bytes())
    assert back.to_bytes() == p2.to_bytes()
    for bad in ([0], [len(p2.entries)], [-1]):  # underflow, unknown ids
        with pytest.raises(PE.KBReferenceError):
            p2.release(bad)
        with pytest.raises(RE.KBReferenceError):
            r2.release(bad)


def _container():
    v = _walks(5, 2, 1500)
    _, pcfg = _configs(v)
    return _stream(PS, pcfg, v, "incremental", 512, "rans", device="cpu")[1]


def _corrupt(blob: bytes, how: str) -> bytes:
    b = bytearray(blob)
    metas, _ = PZ.parse_framed_container(blob)
    if how == "payload_byte":
        b[metas[1].offset + metas[1].length // 2] ^= 0x5A
    elif how == "truncated":
        b = b[: len(b) // 2]
    elif how == "foreign":
        b[:5] = b"XXXXX"
    elif how == "version":
        b[5] = 9
    elif how == "footer_crc":
        b[-8] ^= 0xFF
    elif how == "end_magic":
        b[-1] ^= 0x01
    return bytes(b)


@pytest.mark.parametrize("how", ["payload_byte", "truncated", "foreign", "version",
                                 "footer_crc", "end_magic"])
def test_corrupt_containers_raise_the_same_typed_errors(how):
    blob = _corrupt(_container(), how)
    calls = [
        ("decode_series", lambda m, kw: m.decode_series(blob, 0, 0.0, **kw)),
        ("decode_range", lambda m, kw: m.decode_range(blob, 1, 10, 20, 1e-3, **kw)),
        ("routing_metadata", lambda m, kw: m.routing_metadata(blob)),
    ]
    raised = []
    for what, call in calls:
        errs = []
        for mod, kw in ((R, {}), (P, {"device": "cpu"})):
            try:
                call(mod, kw)
                errs.append(None)
            except ValueError as e:
                errs.append(type(e).__name__)
        assert errs[0] == errs[1], (how, what, errs)
        raised.append(errs[0])
    assert any(raised), how


def test_bad_queries_raise_the_same_typed_errors():
    blob = _container()
    for args in ((7, 0, 10), (0, 50, 50), (0, 1400, 1600), (0, -5, 10)):
        names = []
        for mod, kw in ((R, {}), (P, {"device": "cpu"})):
            with pytest.raises(ValueError) as e:
                mod.decode_range(blob, *args, 0.0, **kw)
            names.append(type(e.value).__name__)
        assert names[0] == names[1], args


def test_stream_codec_kb_store_bytes_equal_reference():
    """``kb_store``, ``inline_kb`` and ``source`` are the reference's: the
    footer carries the store's snapshot ref (and the inline KB only when
    asked), the store's snapshots are the same bytes, and
    ``inline_kb=False`` without a store raises the same typed error."""
    from repro.serving.kbstore import KBStore as RStore

    from repro_torch.serving.kbstore import KBStore as PStore

    v = _walks(3, 2, 1500)
    rcfg, pcfg = _configs(v)
    blobs = []
    for mod, cfg, store, kw in ((RS, rcfg, RStore(rcfg), {}),
                                (PS, pcfg, PStore(pcfg), {"device": "cpu"})):
        for inline in (None, True):
            _, blob = _stream(mod, cfg, v, "incremental", 500, "rans", kb_store=store,
                              inline_kb=inline, source=f"gw{inline}", **kw)
            blobs.append(blob)
        blobs.append([s.blob for s in store.snapshots])
    assert blobs[3:] == blobs[:3]
    assert P.read_knowledge_base(blobs[3]) is None and PZ.read_snapshot_ref(blobs[3]) is not None
    for mod, cfg, kw in ((RS, rcfg, {}), (PS, pcfg, {"device": "cpu"})):
        with pytest.raises(ValueError, match="inline_kb=False requires a kb_store"):
            mod.ShrinkStreamCodec(cfg, [1e-2], inline_kb=False, **kw)


def test_framed_writer_with_snapshot_ref_identical():
    from repro.core import serialize as RZ

    blob = _container()
    metas, kb_bytes = PZ.parse_framed_container(blob)
    out = []
    for mod in (RZ, PZ):
        w = mod.FramedWriter()
        for m in metas:
            w.add_frame(m.series_id, m.t_lo, m.t_hi, m.kb_epoch, PZ.frame_payload(blob, m))
        ref = mod.KBSnapshotRef(version=3, entries=40, sem_id=0xDEADBEEF,
                                remap=(5, 2, 39, 0), refs=(1, 4, 2, 7))
        out.append(w.finish(kb_bytes, snapshot_ref=ref))
        with pytest.raises(ValueError) as e:
            w.finish(kb_bytes)
        out.append(type(e.value).__name__)
        with pytest.raises(ValueError) as e:
            mod.FramedWriter().finish(b"", mod.KBSnapshotRef(1, 2, 3, remap=(0,), refs=()))
        out.append(type(e.value).__name__)
    assert out[:3] == out[3:]
    assert PZ.read_snapshot_ref(out[0]) == PZ.KBSnapshotRef(3, 40, 0xDEADBEEF, (5, 2, 39, 0),
                                                            (1, 4, 2, 7))
    assert P.routing_metadata(out[0]) == R.routing_metadata(out[0])
