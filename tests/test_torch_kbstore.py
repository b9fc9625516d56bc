"""Parity of the port's cross-archive KB store with the reference, on the
CPU: every byte the store and its writers produce is the reference's.

* ``ShrinkStreamCodec`` and ``RaggedBatcher`` with ``kb_store``,
  ``inline_kb`` and ``source``: container bytes (the footer's
  ``kb_snapshot_ref``) and the store's ``SHKS`` snapshots;
* attach / detach / gossip / eviction: ``stats()`` and snapshots;
* ``compact`` (report and re-based containers), ``spill`` / ``load``
  (files and KB views);
* ``resolve_container_kb`` on the golden ``golden_v4_ref.shrks`` and
  ``golden_v4.shks``, and on stale and ref-only containers;
* the range batcher resolving a container's ref through the store;
* corrupt snapshots raise the reference's typed errors.
"""
import dataclasses
import importlib.util
import pathlib

import jax  # noqa: F401
import numpy as np
import pytest

import repro.core as R
from repro.core import errors as RE
from repro.core.semantics import global_range as r_global_range
from repro.serving import batching as RBat
from repro.serving import kbstore as RK
from repro.serving.ragged import RaggedBatcher as RB
from repro.testing import chaos as RC

import repro_torch.core as P
from repro_torch.core import errors as PE
from repro_torch.serving import batching as PBat
from repro_torch.serving import kbstore as PK
from repro_torch.serving.ragged import RaggedBatcher as PB
from repro_torch.testing import chaos as PC

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
_spec = importlib.util.spec_from_file_location("golden_regen", GOLDEN / "regen.py")
golden = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(golden)

SIDES = {"ref": (R, RK, {}), "port": (P, PK, {"device": "cpu"})}


def _motif_archives(n: int, seed: int = 0) -> list[np.ndarray]:
    """Archives tiling a small bank of piecewise-linear motifs, so their
    KB lines repeat across archives (the ``--mode kbstore`` corpus)."""
    rng = np.random.default_rng(seed)
    bank = []
    for _ in range(5):
        knots = np.sort(rng.choice(np.arange(4, 92), 9, replace=False))
        xs = np.concatenate([[0], knots, [95]])
        ys = np.round(rng.uniform(-4.0, 4.0, size=xs.size), 1)
        bank.append(np.round(np.interp(np.arange(96), xs, ys), 3))
    return [np.concatenate([bank[rng.integers(0, 5)] for _ in range(3)]) for _ in range(n)]


def _walk_archives(n: int, seed: int = 9) -> list[np.ndarray]:
    """Random-walk archives: lines of their own, which eviction can take."""
    rng = np.random.default_rng(seed)
    return [np.round(np.cumsum(rng.standard_normal(288)) * 0.3, 3) for _ in range(n)]


def _writers(side: str, archives, inline, max_entries=None):
    core, kbs, dev = SIDES[side]
    allv = np.concatenate(archives)
    vr = (float(allv.min()), float(allv.max()))
    cfg = core.ShrinkConfig(eps_b=0.05 * (vr[1] - vr[0]), lam=1e-3)
    store = kbs.KBStore(cfg, max_entries=max_entries)
    blobs = []
    for i, v in enumerate(archives):
        sc = core.ShrinkStreamCodec(cfg, eps_targets=[0.05, 0.0], decimals=3, backend="best",
                                    value_range=vr, frame_len=96, kb_store=store,
                                    inline_kb=inline, source=None if i % 3 == 2 else f"ar{i}",
                                    **dev)
        for lo in range(0, v.size, 50):
            sc.ingest(v[lo : lo + 50])
        blobs.append(sc.finalize())
        if i == 1:  # a re-finalize under the same handle replaces, never double-counts
            blobs.append(sc.finalize())
    return store, blobs


def _ref(kbs, blob):
    ref = kbs.read_snapshot_ref(blob)
    return None if ref is None else dataclasses.astuple(ref)


def _snaps(store):
    return [(s.version, s.entries, s.sem_id, s.blob) for s in store.snapshots]


@pytest.mark.parametrize("inline", [None, True])
@pytest.mark.parametrize("max_entries", [None, 12])
def test_store_writers_snapshots_and_lifecycle_equal_reference(inline, max_entries, tmp_path):
    archives = _motif_archives(5) + _walk_archives(2)
    (rs, rblobs), (ps, pblobs) = (_writers(s, archives, inline, max_entries) for s in SIDES)
    assert pblobs == rblobs
    assert [_ref(PK, b) for b in pblobs] == [_ref(RK, b) for b in rblobs]
    assert _snaps(ps) == _snaps(rs)
    assert ps.stats() == rs.stats()
    # detach a few, gossip a KB under a stable handle twice, compact
    for st in (rs, ps):
        for h in ("ar0", "ar4", "ar6"):
            st.detach(h)
    rkb = R.read_knowledge_base(rblobs[3]) or rs.container_kb(RK.read_snapshot_ref(rblobs[3]))
    pkb = P.read_knowledge_base(pblobs[3]) or ps.container_kb(PK.read_snapshot_ref(pblobs[3]))
    assert pkb.to_bytes() == rkb.to_bytes()
    for _ in range(2):
        assert ps.gossip("shard0", pkb) == rs.gossip("shard0", rkb)
    assert ps.stats() == rs.stats()
    rep_r, rep_p = rs.compact(), ps.compact()
    assert rep_p == rep_r
    assert _snaps(ps) == _snaps(rs)
    for h in rep_r["rebased"]:
        assert ps.container(h) == rs.container(h)
    # spill, load: the same files, the same KB views from the loaded store
    paths_p = ps.spill(tmp_path / "p")
    paths_r = rs.spill(tmp_path / "r")
    assert [pathlib.Path(p).read_bytes() for p in paths_p] == [
        pathlib.Path(p).read_bytes() for p in paths_r]
    lr, lp = RK.KBStore.load(tmp_path / "r"), PK.KBStore.load(tmp_path / "p")
    assert lp.sem_id() == lr.sem_id() and lp.stats() == lr.stats()
    for h in rep_r["rebased"]:
        ref = PK.read_snapshot_ref(ps.container(h))
        assert lp.container_kb(ref).to_bytes() == lr.container_kb(
            RK.read_snapshot_ref(rs.container(h))).to_bytes()


def _golden_store(side: str):
    """The golden series streamed into a store-attached container, as
    ``tests/golden/regen.py`` builds ``golden_v4_ref.shrks``."""
    core, kbs, dev = SIDES[side]
    v = golden.golden_series()
    cfg = core.ShrinkConfig(eps_b=0.05 * float(v.max() - v.min()), lam=1e-3)
    store = kbs.KBStore(cfg)
    sc = core.ShrinkStreamCodec(cfg, eps_targets=golden.EPS_TARGETS, decimals=golden.DECIMALS,
                                backend="rans", value_range=r_global_range(v),
                                frame_len=golden.FRAME_LEN, kb_store=store, inline_kb=True,
                                source="golden", **dev)
    for lo in range(0, golden.N, 100):
        sc.ingest(v[lo : lo + 100])
    return store, sc.finalize()


def test_golden_kbstore_fixtures_rebuilt_and_resolved():
    """``golden_v4_ref.shrks`` (inline KB and ref) and ``golden_v4.shks``
    (the snapshot it names) rebuilt byte for byte by the port, and the
    reader's fallback ladder gives the reference's KB and origin."""
    store, blob = _golden_store("port")
    assert blob == golden.GOLDEN_REF.read_bytes()
    assert store.snapshots[-1].blob == golden.GOLDEN_KBSTORE.read_bytes()
    snap = golden.GOLDEN_KBSTORE.read_bytes()
    pv, psem, pmaster, ptombs = PK.snapshot_from_bytes(snap)
    rv, rsem, rmaster, rtombs = RK.snapshot_from_bytes(snap)
    assert (pv, psem, ptombs) == (rv, rsem, rtombs)
    assert pmaster.to_bytes() == rmaster.to_bytes()
    assert PK.snapshot_to_bytes(pv, psem, pmaster, sorted(ptombs)) == snap
    rstore, _ = _golden_store("ref")
    for st_p, st_r in ((store, rstore), (None, None)):
        kb_p, origin_p = PK.resolve_container_kb(blob, st_p)
        kb_r, origin_r = RK.resolve_container_kb(blob, st_r)
        assert origin_p == origin_r and kb_p.to_bytes() == kb_r.to_bytes()


@pytest.mark.parametrize("inline", [None, True])
def test_stale_and_ref_only_containers_resolve_like_the_reference(inline):
    archives = _motif_archives(3, seed=4)
    outcomes = []
    for side in SIDES:
        store, blobs = _writers(side, archives, inline)
        kbs = SIDES[side][1]
        chaos = PC if side == "port" else RC
        row = []
        for blob in (blobs[0], chaos.stale_snapshot_ref(blobs[0])[0]):
            for st in (store, None):
                try:
                    kb, origin = kbs.resolve_container_kb(blob, st)
                    row.append((origin, kb.to_bytes() if kb is not None else None))
                except ValueError as e:  # both packages' typed errors
                    row.append((type(e).__name__, str(e)))
        outcomes.append(row)
    assert outcomes[1] == outcomes[0]


@pytest.mark.parametrize("inline", [None, True])
def test_range_batcher_resolves_refs_through_the_store(inline):
    archives = _motif_archives(3, seed=2)
    got = []
    for side, bat in (("ref", RBat), ("port", PBat)):
        store, blobs = _writers(side, archives, inline)
        dev = SIDES[side][2]
        row = [bat.RangeQueryBatcher(blobs[1], kb_store=store, **dev).stats["kb_source"],
               bat.RangeQueryBatcher(blobs[1], **dev).stats["kb_source"]]
        stale = (PC if side == "port" else RC).stale_snapshot_ref(blobs[1])[0]
        try:
            row.append(bat.RangeQueryBatcher(stale, kb_store=store, **dev).stats["kb_source"])
        except ValueError as e:
            row.append(type(e).__name__)
        got.append(row)
    assert got[1] == got[0]


def test_ragged_batcher_with_a_store_equals_reference():
    traffic = golden.golden_ragged_series()
    out = []
    for side, mod in (("ref", RB), ("port", PB)):
        core, kbs, dev = SIDES[side]
        cfg = core.ShrinkConfig(eps_b=0.2, lam=1e-3)
        store = kbs.KBStore(cfg)
        blobs = []
        for inline, source in ((None, "g0"), (True, "g1"), (False, None)):
            b = mod(cfg, eps_targets=[1e-2], backend="rans", flush_samples=600,
                    kb_store=store, inline_kb=inline, source=source, **dev)
            for sid, v in enumerate(traffic):
                b.submit(sid, v)
            blobs.append(b.finalize())
        out.append((blobs, _snaps(store), store.stats()))
    assert out[1] == out[0]


@pytest.mark.parametrize("cut", ["flip", "truncate", "foreign", "tombstone"])
def test_corrupt_snapshots_raise_the_reference_errors(cut):
    snap = golden.GOLDEN_KBSTORE.read_bytes()
    if cut == "flip":
        bad = snap[:9] + bytes([snap[9] ^ 4]) + snap[10:]
    elif cut == "truncate":
        bad = snap[: len(snap) // 2]
    elif cut == "foreign":
        bad = b"SHKX" + snap[4:]
    else:  # a tombstone id past the id space, CRC re-sealed
        rv, rsem, rmaster, _ = RK.snapshot_from_bytes(snap)
        bad = RK.snapshot_to_bytes(rv, rsem, rmaster, [10_000])
    errs = []
    for kbs in (RK, PK):
        with pytest.raises(ValueError) as e:
            kbs.snapshot_from_bytes(bad)
        errs.append((type(e.value).__name__, str(e.value)))
    assert errs[1] == errs[0]


def test_store_rejects_what_the_reference_rejects():
    for kbs, core, errs in ((RK, R, RE), (PK, P, PE)):
        with pytest.raises(errs.ConfigError):
            kbs.KBStore(core.ShrinkConfig(eps_b=0.1), max_entries=0)
        st = kbs.KBStore(core.ShrinkConfig(eps_b=0.1))
        for call in (st.detach, st.container, lambda h: st.register_container(h, b"")):
            with pytest.raises(errs.KBReferenceError):
                call("nobody")
