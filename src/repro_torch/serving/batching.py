"""Continuous-batching request schedulers, counterpart of
``repro.serving.batching``: the LM decode loop (``Request``,
``ContinuousBatcher``) and range-query serving over a ``SHRKS`` framed
container (``RangeQuery``, ``RangeQueryBatcher``).

``ContinuousBatcher`` runs a fixed-slot batch: requests occupy slots,
finished slots take queued requests, and all slots share one decode step
at a single shared cache index; per-slot validity lives in the caches'
kpos masks.  Prompts are fed token by token.

Range queries are queued, resolved to the frames they touch, and served
through an LRU of per-frame :class:`ProgressiveDecoder`s on the batcher's
device (default the card): N queries on one hot frame cost one frame
parse, and a finer query on a cached frame decodes only the layers below
its cached prefix.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque
from typing import Callable, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.errors import (
    CorruptFrameError,
    LayerCorruptError,
    RangeCoverageError,
    UnknownSeriesError,
)
from ..core.serialize import frame_payload, parse_framed_container, read_snapshot_ref
from ..core.shrink import ProgressiveDecoder, cs_from_bytes

__all__ = ["ContinuousBatcher", "RangeQuery", "RangeQueryBatcher", "Request"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # [S] int32
    max_new_tokens: int
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False


class ContinuousBatcher:
    """decode_fn(tokens [B, 1] int64 tensor on ``device``, caches, index int)
    -> (logits [B, 1, V], caches).

    All slots advance with one shared cache index (the number of steps so
    far); per-slot validity comes from the kpos masks.  ``device`` is where
    the token batch is built (the card unless ``device="cpu"``); the next
    tokens come back to the host once a step, as the reference's do.
    """

    def __init__(
        self,
        decode_fn: Callable,
        make_caches: Callable[[], object],
        n_slots: int,
        eos_token: int = 2,
        greedy: bool = True,
        device: torch.device | str | None = None,
    ):
        self.decode_fn = decode_fn
        self.device = resolve_device(device)
        self.caches = make_caches()
        self.n_slots = n_slots
        self.eos = eos_token
        self.greedy = greedy
        self.queue: deque[Request] = deque()
        self.slots: list[Optional[Request]] = [None] * n_slots
        self.slot_pos = np.zeros(n_slots, dtype=np.int64)  # next prompt index
        self.global_index = 0
        self.completed: list[Request] = []

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit(self) -> None:
        for i in range(self.n_slots):
            if self.slots[i] is None and self.queue:
                self.slots[i] = self.queue.popleft()
                self.slot_pos[i] = 0

    def step(self) -> bool:
        """One decode step for all active slots; True while work remains."""
        self._admit()
        if all(s is None for s in self.slots) and not self.queue:
            return False
        tokens = np.zeros((self.n_slots, 1), dtype=np.int64)
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            p = int(self.slot_pos[i])
            if p < len(req.prompt):
                tokens[i, 0] = req.prompt[p]
            elif req.generated:
                tokens[i, 0] = req.generated[-1]
        logits, self.caches = self.decode_fn(
            torch.from_numpy(tokens).to(self.device), self.caches, self.global_index
        )
        nxt = logits[:, -1, :].argmax(dim=-1).cpu().numpy()
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            self.slot_pos[i] += 1
            if self.slot_pos[i] >= len(req.prompt):
                tok = int(nxt[i])
                req.generated.append(tok)
                if tok == self.eos or len(req.generated) >= req.max_new_tokens:
                    req.done = True
                    self.completed.append(req)
                    self.slots[i] = None
        self.global_index += 1
        return True

    def run(self, max_steps: int = 10_000) -> list[Request]:
        steps = 0
        while self.step() and steps < max_steps:
            steps += 1
        return self.completed


@dataclasses.dataclass
class RangeQuery:
    """One range-decode request: reconstruct samples [t0, t1) of
    ``series_id`` at resolution ``eps``.  ``result`` is a float64 tensor on
    the batcher's device; ``achieved`` the guarantee of the tier served
    (<= eps on success; coarser only for ``peek`` sketches, or when
    ``degraded`` marks that corruption forced a coarser answer)."""

    qid: int
    series_id: int
    t0: int
    t1: int
    eps: float
    result: Optional[torch.Tensor] = None
    achieved: Optional[float] = None
    error: Optional[str] = None
    degraded: bool = False


class RangeQueryBatcher:
    """Progressive batched random-access decode over a ``SHRKS`` container.

    The directory is parsed once; the LRU caches one
    :class:`ProgressiveDecoder` per hot frame (its decoded layer prefix):
    a coarse query decodes only the coarse layers, a finer one later pays
    only for the layers below the cached prefix (``layer_hits`` counts the
    layers it did not decode again), and ``peek`` answers from what is
    already materialized with no entropy work.  Frame payload CRCs are
    checked on first touch.

    ``degraded_ok=True`` serves a query whose frame has a corrupt pyramid
    layer from the finest intact prefix (``q.degraded``, ``q.achieved``
    the bound delivered), and a frame whose residual section is unusable
    but whose header/base CRC holds from its base; a frame that cannot
    prove its base still errors.  ``kb_store`` is only ``None``: the port
    has no KB store yet (ROADMAP queue 1 item 8, KBStore).
    """

    def __init__(
        self,
        blob: bytes,
        cache_frames: int = 32,
        degraded_ok: bool = False,
        kb_store=None,
        device: torch.device | str | None = None,
    ):
        if kb_store is not None:
            raise NotImplementedError(
                "kb_store: the port has no KB store yet (ROADMAP queue 1 item 8, KBStore)"
            )
        self.degraded_ok = bool(degraded_ok)
        self.device = resolve_device(device)
        self._blob = bytes(blob)
        metas, kb_bytes = parse_framed_container(self._blob)
        self._frames: dict[int, list] = {}
        for m in metas:
            self._frames.setdefault(m.series_id, []).append(m)
        for frames in self._frames.values():
            frames.sort(key=lambda m: m.t_lo)
        self._cache: OrderedDict[int, ProgressiveDecoder] = OrderedDict()
        self._cache_frames = cache_frames
        self.queue: deque[RangeQuery] = deque()
        self.completed: list[RangeQuery] = []
        if kb_bytes:
            kb_source = "inline"
        else:
            kb_source = "ref-unresolved" if read_snapshot_ref(self._blob) else "none"
        self.stats = {
            "queries": 0,
            "frames_decoded": 0,
            "frame_hits": 0,
            "layers_decoded": 0,
            "layer_hits": 0,
            "errors": 0,
            "degraded": 0,
            "kb_source": kb_source,
        }

    @property
    def blob(self) -> bytes:
        """The raw container bytes (frame payloads are slices of this)."""
        return self._blob

    @property
    def series_ids(self) -> list[int]:
        return sorted(self._frames)

    def span(self, series_id: int) -> tuple[int, int]:
        """[t_lo, t_hi) covered by a series' frames."""
        frames = self._frames.get(series_id)
        if not frames:
            raise UnknownSeriesError(f"unknown series {series_id}", series_id=series_id)
        return frames[0].t_lo, frames[-1].t_hi

    def submit(self, q: RangeQuery) -> None:
        self.queue.append(q)

    def decoder(self, meta) -> ProgressiveDecoder:
        """The cached :class:`ProgressiveDecoder` of one frame (parsed on
        first touch).  The analytics engine refines through the same LRU,
        so range decodes and aggregates never decode a layer twice."""
        dec = self._cache.get(meta.offset)
        if dec is not None:
            self._cache.move_to_end(meta.offset)
            self.stats["frame_hits"] += 1
            return dec
        try:
            cs = cs_from_bytes(frame_payload(self._blob, meta))
        except CorruptFrameError:
            if not self.degraded_ok:
                raise
            # tolerant path: skip the frame CRC and quarantine corrupt
            # layers; cs_from_bytes still checks the SHRK header/base CRC
            # and raises when the base itself cannot be trusted
            cs = cs_from_bytes(frame_payload(self._blob, meta, verify_crc=False), strict=False)
        dec = ProgressiveDecoder(cs, self.device)
        self.stats["frames_decoded"] += 1
        self._cache[meta.offset] = dec
        while len(self._cache) > self._cache_frames:
            self._cache.popitem(last=False)
        return dec

    def _decoded_frame(self, meta, eps: float) -> tuple[torch.Tensor, float, bool]:
        dec = self.decoder(meta)
        k = dec.cs.pyramid.resolve(eps, dec.cs.eps_b_practical)
        degraded = False
        intact = dec.intact_depth()
        if k > intact:
            if not self.degraded_ok:
                raise LayerCorruptError(
                    f"frame needs layer prefix {k} but finest intact prefix is {intact}",
                    series_id=meta.series_id, layer=intact + 1,
                )
            k = intact
            degraded = True
        before = dec.layers_decoded
        vals = dec.prefix(k)
        paid = dec.layers_decoded - before
        self.stats["layers_decoded"] += paid
        # the cached prefix covered the rest of the k + 1 layers (identity
        # layers are free by construction)
        needed = sum(1 for layer in dec.cs.pyramid.layers[: k + 1] if layer.mode != "identity")
        self.stats["layer_hits"] += needed - paid
        return vals, dec.guarantee(k), degraded

    def frames_overlapping(self, series_id: int, t0: int, t1: int) -> list:
        """Directory entries of the frames covering samples [t0, t1) of a
        series, in time order; raises :class:`UnknownSeriesError` or
        :class:`RangeCoverageError` for an unknown series or a range the
        frames do not cover."""
        frames = self._frames.get(series_id)
        if not frames:
            raise UnknownSeriesError(f"unknown series {series_id}", series_id=series_id)
        touched = [m for m in frames if m.t_lo < t1 and m.t_hi > t0]
        if t1 <= t0 or not touched or touched[0].t_lo > t0 or touched[-1].t_hi < t1:
            raise RangeCoverageError(
                f"range [{t0}, {t1}) not covered by series {series_id} frames "
                f"[{frames[0].t_lo}, {frames[-1].t_hi})",
                series_id=series_id,
            )
        return touched

    def _serve(self, q: RangeQuery) -> None:
        touched = self.frames_overlapping(q.series_id, q.t0, q.t1)
        out = torch.empty(q.t1 - q.t0, dtype=torch.float64, device=self.device)
        achieved = 0.0
        degraded = False
        expected = q.t0
        for i, m in enumerate(touched):
            if m.t_lo > expected:
                raise RangeCoverageError(
                    f"gap in series {q.series_id} frames at sample {expected} "
                    f"(next frame covers [{m.t_lo}, {m.t_hi}))",
                    series_id=q.series_id, frame_index=i,
                )
            vals, guarantee, frame_degraded = self._decoded_frame(m, q.eps)
            achieved = max(achieved, guarantee)
            degraded = degraded or frame_degraded
            lo, hi = max(q.t0, m.t_lo), min(q.t1, m.t_hi)
            out[lo - q.t0 : hi - q.t0] = vals[lo - m.t_lo : hi - m.t_lo]
            expected = hi
        q.result = out
        q.achieved = achieved
        q.degraded = degraded
        if degraded:
            self.stats["degraded"] += 1

    def peek(self, q: RangeQuery) -> Optional[torch.Tensor]:
        """Serve ``q`` from already-cached layer prefixes with no entropy
        decode: a coarse sketch (``q.result``, with ``q.achieved`` the
        coarsest cached guarantee among the touched frames), or ``None``
        when a touched frame is cold.  ``run`` later pays only for the
        missing layers."""
        try:
            touched = self.frames_overlapping(q.series_id, q.t0, q.t1)
        except ValueError:
            return None
        parts: list[tuple] = []
        achieved = 0.0
        expected = q.t0
        for m in touched:
            if m.t_lo > expected:
                return None
            dec = self._cache.get(m.offset)
            avail = dec.available() if dec is not None else None
            if avail is None:
                return None
            vals, guarantee = avail
            achieved = max(achieved, guarantee)
            parts.append((m, vals))
            expected = m.t_hi
        out = torch.empty(q.t1 - q.t0, dtype=torch.float64, device=self.device)
        for m, vals in parts:
            lo, hi = max(q.t0, m.t_lo), min(q.t1, m.t_hi)
            out[lo - q.t0 : hi - q.t0] = vals[lo - m.t_lo : hi - m.t_lo]
        q.result = out
        q.achieved = achieved
        return out

    def run(self) -> list[RangeQuery]:
        """Drain the queue; returns the queries completed by this call."""
        done: list[RangeQuery] = []
        while self.queue:
            q = self.queue.popleft()
            self.stats["queries"] += 1
            try:
                self._serve(q)
            except (ValueError, KeyError) as e:
                q.error = str(e)
                self.stats["errors"] += 1
            done.append(q)
        self.completed.extend(done)
        return done
