"""Persistent cross-archive knowledge-base store, counterpart of
``repro.serving.kbstore`` (host code: dictionaries and bytes, no tensors).

Each ``SHRKS`` archive carries its own ``KnowledgeBase`` in its footer, so
semantic lines that repeat across archives, tenants and fleet shards are
stored once per archive.  :class:`KBStore` is the shared dictionary:

* **One ref-counted id space.**  ``attach_kb`` folds a container's KB into
  the store (``KnowledgeBase.merge``: identical lines dedup, refcounts
  sum) and records which store entries the attachment references with
  which counts, so ``detach`` reverses it exactly.  Re-attaching under
  the same handle first releases the previous contribution.
* **Versioned snapshots containers reference by id.**  Every attach seals
  a :class:`StoreSnapshot` (``SHKS`` bytes, a CRC-sealed wrapper around
  the ``SHKB`` layout, docs/wire-format.md) and returns a
  :class:`~repro_torch.core.serialize.KBSnapshotRef` for the container
  footer; ``resolve`` proves a ref matches its snapshot before binding
  (:class:`~repro_torch.core.errors.StaleSnapshotError` otherwise), and
  ``container_kb`` rebuilds the container's KB view from the store.
* **Eviction, spill/load, compaction.**  Zero-ref entries no live
  attachment pins are evicted LRU past ``max_entries`` (tombstoned: ids
  never shift); ``spill``/``load`` persist and restore the snapshots;
  ``compact`` drops tombstones, renumbers, reseals one snapshot and
  re-bases every registered ref-mode container, checking that the frame
  bytes did not change.

Every byte this module writes equals the reference's for the same calls.
"""
from __future__ import annotations

import dataclasses
import pathlib
import struct
import zlib

from ..core.errors import (
    ConfigError,
    CorruptFrameError,
    FormatError,
    KBReferenceError,
    ShrinkError,
    StaleSnapshotError,
    TruncatedArchiveError,
)
from ..core.serialize import (
    FramedWriter,
    KBSnapshotRef,
    frame_payload,
    parse_framed_container,
    read_snapshot_ref,
    read_varint,
    write_varint,
)
from ..core.streaming import KBEntry, KnowledgeBase, _slope_key
from ..core.types import ShrinkConfig

__all__ = [
    "KBStore",
    "StoreSnapshot",
    "AttachRecord",
    "snapshot_to_bytes",
    "snapshot_from_bytes",
    "resolve_container_kb",
]

_SNAP_MAGIC = b"SHKS"
_SNAP_VERSION = 1
_TAIL_LEN = 16  # SHRKS tail: u64 footer offset + u32 footer crc + end magic


@dataclasses.dataclass(frozen=True)
class StoreSnapshot:
    """One sealed, immutable store state: ``version`` is the monotonic
    snapshot counter, ``entries`` the total positional id space (live +
    tombstoned), ``sem_id`` the order-invariant semantic identity of the
    live lines, ``blob`` the serialized ``SHKS`` bytes."""

    version: int
    entries: int
    sem_id: int
    blob: bytes


@dataclasses.dataclass(frozen=True)
class AttachRecord:
    """Receipt for one attachment: the ``handle`` to ``detach`` with, and
    the :class:`KBSnapshotRef` for the container footer (``None`` when the
    attach was sealed without a snapshot, e.g. fleet gossip)."""

    handle: str
    ref: KBSnapshotRef | None


# --------------------------------------------------------------------- #
# SHKS snapshot blob (normative layout in docs/wire-format.md)
# --------------------------------------------------------------------- #
def snapshot_to_bytes(
    version: int, sem_id: int, live_kb: KnowledgeBase, tombstones: list[int]
) -> bytes:
    """Serialize one store snapshot: ``SHKS`` wrapper (version, semantic
    id, gap-coded tombstone ids) around the live entries' ``SHKB`` blob,
    CRC-sealed over everything."""
    buf = bytearray()
    buf += _SNAP_MAGIC
    buf.append(_SNAP_VERSION)
    write_varint(buf, version)
    buf += struct.pack("<I", sem_id & 0xFFFFFFFF)
    write_varint(buf, len(tombstones))
    prev = -1
    for t in tombstones:  # strictly ascending; gap coding cannot encode otherwise
        write_varint(buf, t - prev - 1)
        prev = t
    kb_bytes = live_kb.to_bytes()
    write_varint(buf, len(kb_bytes))
    buf += kb_bytes
    buf += struct.pack("<I", zlib.crc32(bytes(buf)) & 0xFFFFFFFF)
    return bytes(buf)


def snapshot_from_bytes(
    data: bytes,
) -> tuple[int, int, KnowledgeBase, set[int]]:
    """Decode an ``SHKS`` blob to ``(version, sem_id, master_kb,
    tombstones)``.  ``master_kb`` has the snapshot's full positional id
    space: live entries at their original ids, zeroed placeholder husks at
    tombstoned ids (excluded from the lookup index).  Raises the usual
    typed taxonomy on foreign/truncated/corrupt input; the trailing CRC
    covers every preceding byte, so bit flips and trailing garbage both
    surface as :class:`CorruptFrameError`."""
    data = bytes(data)
    if len(data) < 5 or data[:4] != _SNAP_MAGIC:
        raise FormatError("bad snapshot magic: not an SHKS blob")
    if data[4] != _SNAP_VERSION:
        raise FormatError(f"unsupported SHKS version {data[4]}")
    if len(data) < 9:
        raise TruncatedArchiveError("truncated SHKS snapshot: missing CRC")
    (crc_stored,) = struct.unpack_from("<I", data, len(data) - 4)
    if zlib.crc32(data[:-4]) & 0xFFFFFFFF != crc_stored:
        raise CorruptFrameError("corrupt SHKS snapshot: CRC mismatch")
    try:
        pos = 5
        version, pos = read_varint(data, pos)
        (sem_id,) = struct.unpack_from("<I", data, pos)
        pos += 4
        n_tomb, pos = read_varint(data, pos)
        tombs: list[int] = []
        prev = -1
        for _ in range(n_tomb):
            gap, pos = read_varint(data, pos)
            prev = prev + 1 + gap
            tombs.append(prev)
        kb_len, pos = read_varint(data, pos)
        if pos + kb_len != len(data) - 4:
            raise CorruptFrameError(
                "corrupt SHKS snapshot: knowledge-base section length mismatch"
            )
        live = KnowledgeBase.from_bytes(data[pos : pos + kb_len])
    except ShrinkError:
        raise
    except (IndexError, struct.error) as e:
        raise TruncatedArchiveError(f"truncated SHKS snapshot: {e}") from e
    total = len(live.entries) + len(tombs)
    if tombs and tombs[-1] >= total:
        raise CorruptFrameError(
            f"corrupt SHKS snapshot: tombstone id {tombs[-1]} outside "
            f"id space [0, {total})",
            entry=tombs[-1],
        )
    if live.snapshot_id() != sem_id:
        raise CorruptFrameError(
            "corrupt SHKS snapshot: semantic id does not match the entries"
        )
    master = KnowledgeBase(live.config)
    tomb_set = set(tombs)
    live_iter = iter(live.entries)
    for eid in range(total):
        if eid in tomb_set:
            master.entries.append(
                KBEntry(level=0, origin_idx=0, slope=0.0, slope_digits=0, refs=0)
            )
        else:
            e = next(live_iter)
            key = (e.level, e.origin_idx) + _slope_key(e.slope, e.slope_digits)
            master._index[key] = eid
            master.entries.append(e)
    return version, sem_id, master, tomb_set


# --------------------------------------------------------------------- #
# The store
# --------------------------------------------------------------------- #
class KBStore:
    """Shared, versioned, ref-counted knowledge-base store (module
    docstring has the full contract).

    ``max_entries`` bounds the *live* entry count: exceeding it evicts
    zero-ref, unpinned entries LRU (entries referenced by any live
    attachment are never evicted — the store may transiently exceed the
    bound when everything is referenced).
    """

    def __init__(self, config: ShrinkConfig, max_entries: int | None = None):
        if max_entries is not None and max_entries <= 0:
            raise ConfigError(f"max_entries must be positive, got {max_entries}")
        self.config = config
        self.kb = KnowledgeBase(config)
        self.max_entries = max_entries
        self._tombstones: set[int] = set()
        self._touch: dict[int, int] = {}
        self._seq = 0
        self._auto = 0
        # handle -> {store id: refcount contributed}; handle -> local->store remap
        self._handles: dict[str, dict[int, int]] = {}
        self._remaps: dict[str, list[int]] = {}
        # store id -> number of live attachments whose remap names it
        self._pins: dict[int, int] = {}
        self._containers: dict[str, bytes] = {}
        self._snapshots: list[StoreSnapshot] = []
        self._next_version = 1
        self.counters = {
            "attaches": 0,
            "detaches": 0,
            "evictions": 0,
            "compactions": 0,
            "spills": 0,
        }

    # -- identity / views ---------------------------------------------- #
    @property
    def live_count(self) -> int:
        return len(self.kb.entries) - len(self._tombstones)

    def _live_kb(self) -> KnowledgeBase:
        """A frozen copy of the live entries, in store id order (positional
        ids are *compacted* in this view; the snapshot records the
        tombstone positions to reconstruct the full id space)."""
        kb = KnowledgeBase(self.config)
        for eid, e in enumerate(self.kb.entries):
            if eid in self._tombstones:
                continue
            key = (e.level, e.origin_idx) + _slope_key(e.slope, e.slope_digits)
            kb._index[key] = len(kb.entries)
            kb.entries.append(dataclasses.replace(e))
        return kb

    def sem_id(self) -> int:
        """Order-invariant semantic identity of the live lines (the same
        quantity as ``KnowledgeBase.snapshot_id`` — equal to the merged
        global KB's id when the store's sources are exactly those KBs)."""
        return self._live_kb().snapshot_id()

    def stats(self) -> dict:
        live_refs = sum(
            e.refs
            for eid, e in enumerate(self.kb.entries)
            if eid not in self._tombstones
        )
        return {
            "entries": len(self.kb.entries),
            "live": self.live_count,
            "tombstones": len(self._tombstones),
            "total_refs": live_refs,
            "dedup_ratio": live_refs / self.live_count if self.live_count else 1.0,
            "handles": len(self._handles),
            "containers": len(self._containers),
            "snapshots": len(self._snapshots),
            "next_version": self._next_version,
            "counters": dict(self.counters),
        }

    # -- attach / detach ----------------------------------------------- #
    def attach_kb(
        self,
        kb: KnowledgeBase,
        source: str | None = None,
        snapshot: bool = True,
    ) -> AttachRecord:
        """Fold a container/shard KB into the store with exact reference
        accounting.  Re-attaching an existing ``source`` handle first
        releases its previous contribution (replace semantics — this is
        what fleet gossip and codec re-finalize rely on).  With
        ``snapshot=True`` the post-attach state is sealed and the returned
        record carries the :class:`KBSnapshotRef` for the container
        footer."""
        handle = f"h{self._auto}" if source is None else str(source)
        if source is None:
            self._auto += 1
        if handle in self._handles:
            self._release_handle(handle)
        remap = self.kb.merge(kb)  # raises ConfigError on config mismatch
        counts: dict[int, int] = {}
        for rid, e in zip(remap, kb.entries):
            self._pins[rid] = self._pins.get(rid, 0) + 1
            self._seq += 1
            self._touch[rid] = self._seq
            if e.refs:
                counts[rid] = counts.get(rid, 0) + e.refs
        self._handles[handle] = counts
        self._remaps[handle] = list(remap)
        self.counters["attaches"] += 1
        self._evict_if_needed()
        ref = None
        if snapshot:
            snap = self.snapshot()
            ref = KBSnapshotRef(
                version=snap.version,
                entries=snap.entries,
                sem_id=snap.sem_id,
                remap=tuple(remap),
                refs=tuple(e.refs for e in kb.entries),
            )
        return AttachRecord(handle=handle, ref=ref)

    def attach(self, blob: bytes, source: str | None = None) -> AttachRecord:
        """Attach a whole self-contained SHRKS container: its inline
        footer KB is folded in and the container is registered for
        compaction re-basing."""
        _, kb_bytes = parse_framed_container(blob)
        if not kb_bytes:
            raise ConfigError(
                "container carries no inline knowledge base to attach "
                "(ref-mode containers are attached by their writer)"
            )
        rec = self.attach_kb(KnowledgeBase.from_bytes(kb_bytes), source=source)
        self._containers[rec.handle] = bytes(blob)
        return rec

    def register_container(self, handle: str, blob: bytes) -> None:
        """Associate the finished container bytes with an attach handle
        (writers call this after ``finish`` — the ref must exist before
        the footer is built).  Registered ref-mode containers are re-based
        by ``compact``."""
        if handle not in self._handles:
            raise KBReferenceError(f"unknown attach handle {handle!r}")
        self._containers[handle] = bytes(blob)

    def container(self, handle: str) -> bytes:
        """The registered (possibly compaction-rebased) container bytes."""
        try:
            return self._containers[handle]
        except KeyError:
            raise KBReferenceError(
                f"no container registered under handle {handle!r}"
            ) from None

    def _release_handle(self, handle: str) -> None:
        counts = self._handles.pop(handle)
        for rid, cnt in counts.items():
            self.kb.release([rid] * cnt)  # typed underflow via KBReferenceError
        for rid in self._remaps.pop(handle):
            self._pins[rid] -= 1
            if not self._pins[rid]:
                del self._pins[rid]
        self._containers.pop(handle, None)
        self.counters["detaches"] += 1

    def detach(self, handle: str) -> None:
        """Reverse one attachment exactly: every refcount it contributed
        is released; entries that drop to zero refs become eviction
        candidates."""
        if handle not in self._handles:
            raise KBReferenceError(f"unknown attach handle {handle!r}")
        self._release_handle(handle)
        self._evict_if_needed()

    def gossip(self, source: str, kb: KnowledgeBase) -> dict:
        """Fleet-shard sync: (re-)attach ``source``'s current KB under its
        stable handle — replace semantics, so repeated syncs of a growing
        shard KB never double-count — and return the epoch-tagged record
        the fleet logs."""
        self.attach_kb(kb, source=source, snapshot=False)
        return {
            "source": source,
            "entries": len(self.kb.entries),
            "live": self.live_count,
            "sem_id": self.sem_id(),
        }

    # -- eviction ------------------------------------------------------ #
    def _evict_if_needed(self) -> int:
        if self.max_entries is None:
            return 0
        evicted = 0
        while self.live_count > self.max_entries:
            victim, oldest = None, None
            for eid, e in enumerate(self.kb.entries):
                if eid in self._tombstones or eid in self._pins or e.refs:
                    continue
                t = self._touch.get(eid, -1)
                if oldest is None or t < oldest:
                    victim, oldest = eid, t
            if victim is None:
                break  # everything is referenced/pinned: bound is soft
            e = self.kb.entries[victim]
            key = (e.level, e.origin_idx) + _slope_key(e.slope, e.slope_digits)
            self.kb._index.pop(key, None)
            self._tombstones.add(victim)
            self._touch.pop(victim, None)
            self.counters["evictions"] += 1
            evicted += 1
        return evicted

    # -- snapshots ----------------------------------------------------- #
    def snapshot(self) -> StoreSnapshot:
        """Seal the current store state into a new versioned ``SHKS``
        snapshot (kept in memory; ``spill`` persists them)."""
        live = self._live_kb()
        sem = live.snapshot_id()
        version = self._next_version
        self._next_version += 1
        blob = snapshot_to_bytes(version, sem, live, sorted(self._tombstones))
        snap = StoreSnapshot(
            version=version, entries=len(self.kb.entries), sem_id=sem, blob=blob
        )
        self._snapshots.append(snap)
        return snap

    @property
    def snapshots(self) -> list[StoreSnapshot]:
        return list(self._snapshots)

    def _find_snapshot(self, version: int) -> StoreSnapshot | None:
        for snap in reversed(self._snapshots):
            if snap.version == version:
                return snap
        return None

    def resolve(self, ref: KBSnapshotRef) -> KnowledgeBase:
        """The master KB view of the snapshot a ref names, after proving
        the ref actually matches it: unknown version, semantic id
        disagreement, id space overrun, or a remap id that was tombstoned
        all raise :class:`StaleSnapshotError` — a ref never silently binds
        to the wrong snapshot."""
        snap = self._find_snapshot(ref.version)
        if snap is None:
            raise StaleSnapshotError(
                f"unknown KB snapshot version {ref.version} "
                f"(store holds {[s.version for s in self._snapshots]})"
            )
        if (ref.sem_id & 0xFFFFFFFF) != snap.sem_id:
            raise StaleSnapshotError(
                f"KB snapshot v{ref.version} semantic id mismatch: "
                f"ref {ref.sem_id:#x} != store {snap.sem_id:#x}"
            )
        if ref.entries > snap.entries:
            raise StaleSnapshotError(
                f"KB snapshot v{ref.version} id space overrun: ref claims "
                f"{ref.entries} entries, snapshot holds {snap.entries}"
            )
        _, _, master, tombs = snapshot_from_bytes(snap.blob)
        for rid in ref.remap:
            if rid in tombs:
                raise StaleSnapshotError(
                    f"kb_snapshot_ref names retired entry {rid} of snapshot "
                    f"v{ref.version}",
                    entry=rid,
                )
        return master

    def container_kb(self, ref: KBSnapshotRef) -> KnowledgeBase:
        """Rebuild a container's private KB view — positional entry ids,
        exact refcounts — from the store snapshot its ref names."""
        master = self.resolve(ref)
        kb = KnowledgeBase(self.config)
        for rid, refs in zip(ref.remap, ref.refs):
            e = master.entries[rid]
            key = (e.level, e.origin_idx) + _slope_key(e.slope, e.slope_digits)
            kb._index[key] = len(kb.entries)
            kb.entries.append(dataclasses.replace(e, refs=refs))
        return kb

    # -- compaction ---------------------------------------------------- #
    def compact(self) -> dict:
        """Garbage-collect the id space: drop tombstones AND zero-ref
        entries no live attachment pins, renumber the survivors, seal one
        compacted snapshot, and re-base every registered ref-mode
        container onto it.  Old snapshots are retired (their refs become
        stale *by design* — the re-based containers carry fresh refs).
        Each rewrite is verified byte-identical over the whole frame
        region before replacing the original, so decode provably cannot
        change."""
        entries_before = len(self.kb.entries)
        old_to_new: dict[int, int] = {}
        new_kb = KnowledgeBase(self.config)
        for eid, e in enumerate(self.kb.entries):
            if eid in self._tombstones:
                continue
            if not e.refs and eid not in self._pins:
                continue  # dead line: no refs, no container names it
            key = (e.level, e.origin_idx) + _slope_key(e.slope, e.slope_digits)
            old_to_new[eid] = len(new_kb.entries)
            new_kb._index[key] = len(new_kb.entries)
            new_kb.entries.append(e)
        self.kb = new_kb
        self._tombstones = set()
        self._handles = {
            h: {old_to_new[r]: c for r, c in counts.items()}
            for h, counts in self._handles.items()
        }
        self._remaps = {
            h: [old_to_new[r] for r in rm] for h, rm in self._remaps.items()
        }
        self._pins = {old_to_new[r]: c for r, c in self._pins.items()}
        self._touch = {
            old_to_new[r]: t for r, t in self._touch.items() if r in old_to_new
        }
        self._snapshots = []
        snap = self.snapshot()
        rebased: list[str] = []
        for handle, blob in list(self._containers.items()):
            old_ref = read_snapshot_ref(blob)
            if old_ref is None:
                continue  # self-contained container: nothing to re-base
            metas, kb_bytes = parse_framed_container(blob)
            w = FramedWriter()
            for m in metas:
                w.add_frame(
                    m.series_id, m.t_lo, m.t_hi, m.kb_epoch,
                    frame_payload(blob, m, verify_crc=True),
                )
            new_ref = KBSnapshotRef(
                version=snap.version,
                entries=snap.entries,
                sem_id=snap.sem_id,
                remap=tuple(self._remaps[handle]),
                refs=old_ref.refs,
            )
            new_blob = w.finish(kb_bytes, snapshot_ref=new_ref)
            (old_fo,) = struct.unpack_from("<Q", blob, len(blob) - _TAIL_LEN)
            (new_fo,) = struct.unpack_from("<Q", new_blob, len(new_blob) - _TAIL_LEN)
            if blob[:old_fo] != new_blob[:new_fo]:
                raise CorruptFrameError(
                    f"compaction changed frame bytes of container {handle!r}"
                )
            self._containers[handle] = new_blob
            rebased.append(handle)
        self.counters["compactions"] += 1
        return {
            "version": snap.version,
            "entries_before": entries_before,
            "entries_after": len(self.kb.entries),
            "dropped": entries_before - len(self.kb.entries),
            "rebased": rebased,
        }

    # -- spill / load -------------------------------------------------- #
    def spill(self, directory) -> list[str]:
        """Persist every in-memory snapshot to ``directory`` as
        ``kbsnap_v<version>.shks`` files; returns the paths written."""
        d = pathlib.Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        paths = []
        for snap in self._snapshots:
            p = d / f"kbsnap_v{snap.version:08d}.shks"
            p.write_bytes(snap.blob)
            paths.append(str(p))
        self.counters["spills"] += 1
        return paths

    @classmethod
    def load(cls, directory, max_entries: int | None = None) -> "KBStore":
        """Restore a store from spilled ``SHKS`` snapshots: the highest
        version becomes the master state, every snapshot stays resolvable
        for old refs.  Attach handles and registered containers are
        runtime state and are NOT persisted — a loaded store serves
        ``resolve``/``container_kb`` and accepts fresh attachments."""
        d = pathlib.Path(directory)
        paths = sorted(d.glob("*.shks"))
        if not paths:
            raise FormatError(f"no SHKS snapshots under {d}")
        decoded = []
        seen_versions: set[int] = set()
        for p in paths:
            blob = p.read_bytes()
            version, sem, master, tombs = snapshot_from_bytes(blob)
            if version in seen_versions:
                raise FormatError(
                    f"duplicate snapshot version {version} under {d}"
                )
            seen_versions.add(version)
            decoded.append((version, sem, master, tombs, blob))
        decoded.sort(key=lambda x: x[0])
        latest_version, _, master, tombs, _ = decoded[-1]
        store = cls(master.config, max_entries=max_entries)
        store.kb = master
        store._tombstones = set(tombs)
        store._snapshots = [
            StoreSnapshot(
                version=v, entries=len(m.entries), sem_id=s, blob=b
            )
            for v, s, m, _, b in decoded
        ]
        store._next_version = latest_version + 1
        return store


def resolve_container_kb(
    blob: bytes, store: KBStore | None = None
) -> tuple[KnowledgeBase | None, str]:
    """The KB view of a container, with the fallback ladder readers use:
    a ``kb_snapshot_ref`` resolved against ``store`` wins (``"store"``);
    if the ref is stale but an inline footer KB exists, fall back to it
    (``"inline-fallback"``); containers without a ref use their inline KB
    (``"inline"``) or have none (``"none"``).  A ref-only container whose
    ref cannot resolve raises :class:`StaleSnapshotError` — never a
    silently wrong dictionary."""
    _, kb_bytes = parse_framed_container(blob)
    ref = read_snapshot_ref(blob)
    if ref is not None and store is not None:
        try:
            return store.container_kb(ref), "store"
        except ShrinkError:
            if kb_bytes:
                return KnowledgeBase.from_bytes(kb_bytes), "inline-fallback"
            raise
    if kb_bytes:
        return KnowledgeBase.from_bytes(kb_bytes), "inline"
    if ref is not None:
        raise StaleSnapshotError(
            "ref-mode container (no inline knowledge base) but no KB store "
            "was supplied to resolve it"
        )
    return None, "none"
