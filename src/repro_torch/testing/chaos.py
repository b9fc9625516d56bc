"""Deterministic, seeded fault injection for SHRK/SHRKS blobs and decoders,
the port's copy of ``repro.testing.chaos`` (pure byte work: the same seed
gives the same mutant bytes and the same :class:`Fault` in both packages).

Every injector is a function ``bytes -> (bytes, Fault)``, so a test holds
the pristine blob as its oracle and checks the reader's reaction:

* :func:`flip_byte`      — flip one bit anywhere in the blob;
* :func:`truncate`       — cut the blob at any boundary;
* :func:`smash_frame_crc`— rewrite ONE frame's stored CRC in a ``SHRKS``
  directory (footer CRC re-sealed, so the fault surfaces only when that
  frame's payload is read);
* :func:`drop_frame`     — remove one frame (a valid container with a
  coverage gap);
* :func:`stale_snapshot_ref` — make a container's ``kb_snapshot_ref``
  unresolvable;
* :func:`kill_shard`     — take one shard of a serving fleet out (lost, or
  corrupted by one of the faults above);
* :class:`FlakyCallable` — seeded transient failures and injected latency
  around any callable (the gateway's retry path).

:class:`ChaosInjector` draws faults from ``random.Random(seed)`` in the
reference's order, so a campaign replays from its seed.
"""
from __future__ import annotations

import dataclasses
import random
import struct
import zlib
from typing import Callable, Optional

from ..core.errors import TransientError
from ..core.serialize import (
    FramedWriter,
    KBSnapshotRef,
    frame_payload,
    parse_framed_container,
    read_snapshot_ref,
    read_varint,
)
from ..core.types import FrameMeta

__all__ = [
    "Fault",
    "FlakyCallable",
    "ChaosInjector",
    "flip_byte",
    "truncate",
    "smash_frame_crc",
    "drop_frame",
    "stale_snapshot_ref",
    "kill_shard",
    "list_frames",
]

_TAIL_LEN = 16  # u64 footer offset + u32 footer crc + 4-byte end magic


@dataclasses.dataclass(frozen=True)
class Fault:
    """What a single injection did — enough to reproduce it by hand."""

    kind: str  # 'flip' | 'truncate' | 'crc_smash' | 'frame_drop' | 'flaky'
    #     | 'shard_kill' | 'stale_ref'
    offset: Optional[int] = None  # byte offset (flip), cut length (truncate)
    bit: Optional[int] = None
    frame_index: Optional[int] = None
    shard: Optional[int] = None  # which fleet shard a shard_kill hit
    detail: str = ""


# --------------------------------------------------------------------- #
# blob mutators
# --------------------------------------------------------------------- #
def flip_byte(blob: bytes, offset: int, bit: int = 0) -> tuple[bytes, Fault]:
    """Flip one bit of ``blob[offset]``."""
    if not 0 <= offset < len(blob):
        raise IndexError(f"offset {offset} outside blob of {len(blob)} bytes")
    b = bytearray(blob)
    b[offset] ^= 1 << (bit & 7)
    return bytes(b), Fault(
        kind="flip", offset=offset, bit=bit & 7,
        detail=f"flipped bit {bit & 7} of byte {offset}/{len(blob)}",
    )


def truncate(blob: bytes, keep: int) -> tuple[bytes, Fault]:
    """Cut the blob to its first ``keep`` bytes."""
    keep = max(0, min(int(keep), len(blob)))
    return bytes(blob[:keep]), Fault(
        kind="truncate", offset=keep, detail=f"kept {keep}/{len(blob)} bytes"
    )


def list_frames(blob: bytes) -> list[FrameMeta]:
    """The frame directory of a ``SHRKS`` container (no payload checks)."""
    return parse_framed_container(blob)[0]


def _footer_bounds(blob: bytes) -> tuple[int, int]:
    (footer_offset,) = struct.unpack_from("<Q", blob, len(blob) - _TAIL_LEN)
    return footer_offset, len(blob) - _TAIL_LEN


def smash_frame_crc(blob: bytes, frame_index: int) -> tuple[bytes, Fault]:
    """Invert the stored CRC of one frame in a ``SHRKS`` directory and
    re-seal the footer CRC.  The container still parses — the corruption
    surfaces only when that frame's payload is actually read (the SHRKS
    lazy per-frame CRC contract), which is exactly the case the serving
    layer's scoped degradation must handle."""
    metas = list_frames(blob)  # validates the container first
    if not 0 <= frame_index < len(metas):
        raise IndexError(f"frame {frame_index} outside directory of {len(metas)}")
    fo, fe = _footer_bounds(blob)
    footer = blob[fo:fe]
    pos = 0
    _, pos = read_varint(footer, pos)
    crc_pos = None
    for i in range(len(metas)):
        for _ in range(6):  # sid, t_lo, n, epoch, offset, length
            _, pos = read_varint(footer, pos)
        if i == frame_index:
            crc_pos = fo + pos
            break
        pos += 4
    b = bytearray(blob)
    for j in range(4):
        b[crc_pos + j] ^= 0xFF
    new_footer_crc = zlib.crc32(bytes(b[fo:fe])) & 0xFFFFFFFF
    struct.pack_into("<QI", b, len(b) - _TAIL_LEN, fo, new_footer_crc)
    return bytes(b), Fault(
        kind="crc_smash", frame_index=frame_index, offset=crc_pos,
        detail=f"inverted stored CRC of frame {frame_index} (footer re-sealed)",
    )


def drop_frame(blob: bytes, frame_index: int) -> tuple[bytes, Fault]:
    """Rebuild a ``SHRKS`` container without one frame.  The result is a
    fully valid container whose directory has a coverage hole — readers
    must fail (or degrade) on the *gap*, not on a checksum."""
    metas, kb_bytes = parse_framed_container(blob)
    if not 0 <= frame_index < len(metas):
        raise IndexError(f"frame {frame_index} outside directory of {len(metas)}")
    w = FramedWriter()
    for i, m in enumerate(metas):
        if i == frame_index:
            continue
        w.add_frame(
            m.series_id, m.t_lo, m.t_hi, m.kb_epoch,
            frame_payload(blob, m, verify_crc=False),
        )
    dropped = metas[frame_index]
    # a ref-mode container stays ref-mode: carry the kb_snapshot_ref through
    return w.finish(kb_bytes, snapshot_ref=read_snapshot_ref(blob)), Fault(
        kind="frame_drop", frame_index=frame_index,
        detail=(
            f"dropped frame {frame_index} (series {dropped.series_id}, "
            f"samples [{dropped.t_lo}, {dropped.t_hi}))"
        ),
    )


def stale_snapshot_ref(blob: bytes) -> tuple[bytes, Fault]:
    """Rewrite a container's ``kb_snapshot_ref`` so it no longer resolves:
    the version is bumped past any real snapshot and the semantic id is
    inverted.  The container itself stays fully valid (frames, CRCs,
    inline KB all intact) — exactly the operational fault of a store
    losing/compacting away a snapshot that containers still reference.
    Readers must fall back to the inline footer KB when present, or raise
    a typed :class:`StaleSnapshotError` — never bind to a wrong snapshot."""
    metas, kb_bytes = parse_framed_container(blob)
    ref = read_snapshot_ref(blob)
    if ref is None:
        raise ValueError("container carries no kb_snapshot_ref to stale")
    w = FramedWriter()
    for m in metas:
        w.add_frame(
            m.series_id, m.t_lo, m.t_hi, m.kb_epoch,
            frame_payload(blob, m, verify_crc=False),
        )
    bad = KBSnapshotRef(
        version=ref.version + 1_000_000,
        entries=ref.entries,
        sem_id=ref.sem_id ^ 0xFFFFFFFF,
        remap=ref.remap,
        refs=ref.refs,
    )
    return w.finish(kb_bytes, snapshot_ref=bad), Fault(
        kind="stale_ref",
        detail=(
            f"kb_snapshot_ref v{ref.version} -> v{bad.version}, "
            "sem_id inverted (snapshot can no longer resolve)"
        ),
    )


def kill_shard(
    fleet, shard: int, mode: str = "lost", injector: "ChaosInjector | None" = None
) -> Fault:
    """Take one shard of a serving fleet out of action.

    ``fleet`` is duck-typed (anything with ``seal()`` and
    ``inject_shard_blob(shard, blob)`` — in practice
    :class:`repro_torch.serving.ShrinkFleet`), keeping this module free of a
    serving dependency.  Modes:

    * ``"lost"``    — the shard's container is gone (replaced by empty
      bytes): every query to it must come back a typed error;
    * ``"corrupt"`` — one seeded single-blob fault (flip / truncate /
      crc_smash / frame_drop) is applied to the shard's container: queries
      must come back typed errors or flagged degraded answers with valid
      bounds.

    Either way the blast radius is ONE shard — the differential tests
    assert every other shard still serves byte-exact.
    """
    blobs = fleet.seal()
    if not 0 <= shard < len(blobs):
        raise IndexError(f"shard {shard} outside fleet of {len(blobs)}")
    if mode == "lost":
        mutant = b""
        fault = Fault(
            kind="shard_kill", shard=shard,
            detail=f"shard {shard}: container lost (replaced by empty blob)",
        )
    elif mode == "corrupt":
        inj = injector if injector is not None else ChaosInjector(0)
        mutant, inner = inj.corrupt(blobs[shard])
        fault = Fault(
            kind="shard_kill", shard=shard, offset=inner.offset,
            bit=inner.bit, frame_index=inner.frame_index,
            detail=f"shard {shard}: {inner.detail}",
        )
    else:
        raise ValueError(f"unknown kill mode {mode!r}: expected 'lost'|'corrupt'")
    fleet.inject_shard_blob(shard, mutant)
    return fault


# --------------------------------------------------------------------- #
# decoder wrappers
# --------------------------------------------------------------------- #
class FlakyCallable:
    """Wrap a callable in seeded transient failures and injected latency.

    Each call draws from its own ``random.Random(seed)`` stream: with
    probability ``fail_rate`` it raises :class:`TransientError` (the ONLY
    error class the gateway retries) instead of calling through; a
    successful call first invokes ``sleep(slow_s)`` when configured (pass
    a fake sleep to keep tests instant).  ``calls``/``failures`` count
    what happened.
    """

    def __init__(
        self,
        fn: Callable,
        fail_rate: float = 0.0,
        seed: int = 0,
        slow_s: float = 0.0,
        sleep: Callable[[float], None] | None = None,
    ):
        if not 0.0 <= fail_rate <= 1.0:
            raise ValueError(f"fail_rate must be in [0, 1], got {fail_rate}")
        self.fn = fn
        self.fail_rate = fail_rate
        self.slow_s = slow_s
        self.sleep = sleep
        self.rng = random.Random(seed)
        self.calls = 0
        self.failures = 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        if self.fail_rate and self.rng.random() < self.fail_rate:
            self.failures += 1
            raise TransientError(
                f"injected transient fault (call {self.calls})"
            )
        if self.slow_s and self.sleep is not None:
            self.sleep(self.slow_s)
        return self.fn(*args, **kwargs)


# --------------------------------------------------------------------- #
# seeded campaign source
# --------------------------------------------------------------------- #
class ChaosInjector:
    """Seeded source of single faults: same seed, same fault sequence.

    ``corrupt(blob)`` applies ONE randomly chosen fault and returns
    ``(mutant, fault)``; ``kinds`` restricts the menu.  Structural faults
    (CRC smash / frame drop) silently fall back to a byte flip when the
    blob is not a parseable ``SHRKS`` container.
    """

    KINDS = ("flip", "truncate", "crc_smash", "frame_drop")

    def __init__(self, seed: int = 0):
        self.rng = random.Random(seed)

    def corrupt(
        self, blob: bytes, kinds: tuple[str, ...] | None = None
    ) -> tuple[bytes, Fault]:
        kinds = tuple(kinds) if kinds else self.KINDS
        kind = self.rng.choice(kinds)
        if kind == "flip":
            return flip_byte(blob, self.rng.randrange(len(blob)), self.rng.randrange(8))
        if kind == "truncate":
            return truncate(blob, self.rng.randrange(len(blob)))
        # structural SHRKS faults need a parseable container
        try:
            n = len(list_frames(blob))
        except ValueError:
            n = 0
        if n == 0:
            return flip_byte(blob, self.rng.randrange(len(blob)), self.rng.randrange(8))
        idx = self.rng.randrange(n)
        if kind == "crc_smash":
            return smash_frame_crc(blob, idx)
        if kind == "frame_drop":
            return drop_frame(blob, idx)
        raise ValueError(f"unknown fault kind {kind!r}")

    def kill_shard(self, fleet, shard: int | None = None, mode: str | None = None) -> Fault:
        """Kill a (randomly drawn, unless pinned) shard of ``fleet`` in a
        (randomly drawn, unless pinned) mode, seeded from this stream."""
        n = len(fleet.seal())
        if shard is None:
            shard = self.rng.randrange(n)
        if mode is None:
            mode = self.rng.choice(("lost", "corrupt"))
        return kill_shard(fleet, shard, mode=mode, injector=self)

    def flaky(
        self,
        fn: Callable,
        fail_rate: float,
        slow_s: float = 0.0,
        sleep: Callable[[float], None] | None = None,
    ) -> FlakyCallable:
        """A :class:`FlakyCallable` seeded from this injector's stream."""
        return FlakyCallable(
            fn, fail_rate=fail_rate, seed=self.rng.randrange(2**31),
            slow_s=slow_s, sleep=sleep,
        )
