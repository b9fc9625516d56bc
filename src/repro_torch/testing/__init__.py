"""Deterministic fault-injection tooling for the port, counterpart of
``repro.testing``: ``chaos`` wraps any SHRK/SHRKS blob or decoder callable
in seeded, reproducible faults (``launch/serve.py --mode chaos`` and the
fleet's shard-kill tail)."""
from .chaos import (  # noqa: F401
    ChaosInjector,
    Fault,
    FlakyCallable,
    drop_frame,
    flip_byte,
    kill_shard,
    list_frames,
    smash_frame_crc,
    stale_snapshot_ref,
    truncate,
)
