"""Closed-form per-segment aggregates of the analytics path: CUDA kernel,
plain version, wrapper.

Counterpart of ``repro.kernels.segment_agg`` (the Pallas TPU kernel
``segment_agg_kernel`` / ``segment_agg_pallas``, oracle
``repro.kernels.ref.segment_agg_ref``).  For M segment rows, each the line
``theta + slope * i`` over the local window ``i in [a, b)`` (theta, slope,
a, b [M, 1] of one float dtype), returns (sum, sumsq, min, max), each
[M, 1]; rows with ``b <= a`` give the identity (0, 0, +3.4e38, -3.4e38).

The dtype picks the expressions:

* float64 (the analytics path, ``core.segment_algebra``): the per-row
  terms of the reference's ``core.segment_algebra.base_aggregate``,
  ``d1 = S1(b) - S1(a)`` and ``d2 = S2(b) - S2(a)`` with
  ``S1(x) = x(x-1)/2`` and ``S2(x) = x(x-1)(2x-1)/6``, bit for bit.  The
  Pallas body's difference of cubes agrees only while ``2 b^3 < 2^53``
  (windows under ~165,000 samples).
* float32: the Pallas body, held to ``segment_agg_ref`` at 1e-5.

The kernel is ``csrc/segment_agg.cu``; ``segment_agg_plain`` is the same
arithmetic as separate torch ops (divisions by a tensor, so CUDA torch
makes no reciprocal multiply of them), so the two agree bit for bit.

``segment_query`` runs one step of an analytics query in one launch: for
P parts (a segment table resident on the device, packed by
:func:`pack_table`, and a sample range [t0, t1) of it) the overlap search,
then by ``mode`` the rows' (sum, sumsq, min, max) (``"aggregate"``, the
float64 expressions above), their central terms about a per-part ``mu``
(``"central"``) or each part's counts of predictions ``<op>`` two per-part
thresholds (``"count"``).  Its descriptors and its one output buffer are
laid out as ``csrc/segment_agg.cu`` describes; :func:`query_parts` reads
the buffer back part by part.  ``segment_query_plain`` is the same work as
torch ops.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

__all__ = [
    "pack_table", "query_parts", "segment_agg", "segment_agg_cuda", "segment_agg_plain",
    "segment_query", "segment_query_cuda", "segment_query_plain",
]

_BIG = 3.4e38  # the aggregate identity's +-inf stand-in, as the Pallas kernel's
_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d as an IEEE division by a tensor on any device (CUDA torch turns
    ``x / d`` into a reciprocal multiply); the port's exact paths use it."""
    return torch.div(x, torch.tensor(d, dtype=x.dtype, device=x.device))


def _s1(x):
    return _div(x * (x - 1.0), 2.0)


def _s2(x):
    return _div(x * (x - 1.0) * (2.0 * x - 1.0), 6.0)


def segment_agg_plain(theta, slope, a, b):
    if theta.dtype == torch.float64:
        w = b - a
        d1 = _s1(b) - _s1(a)
        d2 = _s2(b) - _s2(a)
    else:
        w = torch.clamp(b - a, min=0.0)
        d1 = (b * (b - 1.0) - a * (a - 1.0)) * 0.5
        d2 = _div(b * (b - 1.0) * (2.0 * b - 1.0) - a * (a - 1.0) * (2.0 * a - 1.0), 6.0)
    live = w > 0.0
    total = w * theta + slope * d1
    sumsq = w * theta * theta + 2.0 * theta * slope * d1 + slope * slope * d2
    va = theta + slope * a
    vb = theta + slope * (b - 1.0)
    # on a tie (-0.0 against 0.0) the second operand, as numpy's minimum
    # and maximum give it; torch.minimum would keep -0.0
    vmin = torch.where(va < vb, va, vb)
    vmax = torch.where(va > vb, va, vb)
    return (
        torch.where(live, total, 0.0),
        torch.where(live, sumsq, 0.0),
        torch.where(live, vmin, _BIG),
        torch.where(live, vmax, -_BIG),
    )


_ARGS = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]


def segment_agg_cuda(theta, slope, a, b):
    """Launch ``csrc/segment_agg.cu``; same contract as
    :func:`segment_agg_plain`."""
    dtype = theta.dtype
    if dtype not in _SUFFIX:
        raise TypeError(f"segment_agg takes float64 or float32 rows, got {dtype}")
    m = theta.numel()
    for name, p in (("theta", theta), ("slope", slope), ("a", a), ("b", b)):
        if p.dtype != dtype or p.numel() != m or p.device != theta.device:
            raise ValueError(f"segment_agg: {name} must be {dtype} [M, 1] on {theta.device}")
    out = torch.empty((4, m), dtype=dtype, device=theta.device)
    if m:
        # the packed rows (theta, slope, a, b): one 16-byte-aligned load of a
        # row's four scalars per thread (two for float64)
        rows = torch.stack([p.reshape(m) for p in (theta, slope, a, b)], dim=1)
        if rows.data_ptr() % 16:
            raise ValueError("segment_agg: packed rows are not 16-byte aligned")
        fn = _build.function("segment_agg", f"segment_agg_{_SUFFIX[dtype]}", _ARGS)
        with torch.cuda.device(theta.device):
            rc = fn(rows.data_ptr(), m, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        _build.check(rc, "segment_agg")
        _build.launches["segment_agg"] += 1
    return tuple(out[k].reshape(m, 1) for k in range(4))


def segment_agg(theta, slope, a, b):
    """The wrapper: the kernel for a CUDA tensor, the plain version for a
    CPU tensor.  Returns (sum, sumsq, min, max), each [M, 1]."""
    if theta.is_cuda:
        return segment_agg_cuda(theta, slope, a, b)
    if theta.device.type != "cpu":
        raise ValueError(f"segment_agg runs on cuda or cpu, got {theta.device}")
    return segment_agg_plain(theta, slope, a, b)


# --------------------------------------------------------------- query step
DESC_WORDS = 8  # (table address, k, t0, t1, row offset, f1 bits, f2 bits, unused)
HEADER_WORDS = 4  # a part's (i0, i1, count at f1, count at f2)
MODES = {"aggregate": (0, 4), "central": (1, 1), "count": (2, 0)}  # (code, float columns)
CMP_CODES = {"gt": 0, "ge": 1, "lt": 2, "le": 3}


def pack_table(t0s, lens, thetas, slopes) -> torch.Tensor:
    """A segment table as the query kernel reads it: one contiguous int64
    [4, k] buffer of t0s, lens and the float64 bits of thetas and slopes."""
    return torch.stack([
        t0s.to(torch.int64), lens.to(torch.int64),
        thetas.to(torch.float64).view(torch.int64), slopes.to(torch.float64).view(torch.int64),
    ]).contiguous()


def _upset(theta, slope, a, b, c, strict: bool) -> torch.Tensor:
    """Per row, the count of i in [a, b) with theta + slope * i > c (>= c
    when not strict): a lower-bound bisection of a fixed number of steps
    (enough for the longest row) against the float predictions."""
    m = b - a
    up = slope > 0.0
    lo, hi = a.clone(), b.clone()
    for _ in range(int(m.max()).bit_length() if m.numel() else 0):
        open_ = lo < hi
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        v = theta + slope * mid.double()
        go = (v > c if strict else v >= c) == up
        hi = torch.where(open_ & go, mid, hi)
        lo = torch.where(open_ & ~go, mid + 1, lo)
    v0 = theta > c if strict else theta >= c
    out = torch.where((slope == 0.0) & v0, m, 0)
    out = torch.where(up, b - lo, out)
    return torch.where(slope < 0.0, lo - a, out)


def _count(theta, slope, a, b, c, op: str) -> torch.Tensor:
    strict = op in ("gt", "le")
    n = _upset(theta, slope, a, b, c, strict)
    return n if op in ("gt", "ge") else (b - a) - n


def segment_query_plain(tables, desc, mode: str, op: str, nrows: int) -> torch.Tensor:
    """The query step as torch ops: ``tables[p]`` is part p's packed table
    (its address in ``desc`` is not read), ``desc`` int64 [P, 8]; returns
    the output buffer of :func:`segment_query_cuda`'s layout."""
    code, ncols = MODES[mode]
    p_n = desc.shape[0]
    dev = desc.device
    out = torch.zeros(HEADER_WORDS * p_n + ncols * nrows, dtype=torch.int64, device=dev)
    hdr = out[: HEADER_WORDS * p_n].view(p_n, HEADER_WORDS)
    rows = []
    for p, (_, k, t0, t1, off, f1, f2, _) in enumerate(desc.cpu().tolist()):
        t0s, lens = tables[p][0], tables[p][1]
        i0 = int(torch.searchsorted(t0s + lens, torch.tensor([t0], device=dev), right=True))
        i1 = int(torch.searchsorted(t0s, torch.tensor([t1], device=dev)))
        n = i1 - i0 if t1 > t0 and i1 > i0 else 0
        hdr[p, 0], hdr[p, 1] = i0, i0 + n
        j = torch.arange(i0, i0 + n, device=dev)
        start = t0s[j]
        rows.append((p, j, torch.clamp(t0 - start, min=0), torch.minimum(t1 - start, lens[j]),
                     off, f1, f2))
    if not rows or not sum(r[1].numel() for r in rows):
        return out
    part = torch.cat([torch.full_like(r[1], r[0]) for r in rows])
    theta = torch.cat([tables[r[0]][2][r[1]] for r in rows]).view(torch.float64)
    slope = torch.cat([tables[r[0]][3][r[1]] for r in rows]).view(torch.float64)
    a, b = torch.cat([r[2] for r in rows]), torch.cat([r[3] for r in rows])
    pos = torch.cat([r[4] + torch.arange(r[1].numel(), device=dev) for r in rows])

    def per_row(word: int) -> torch.Tensor:
        bits = torch.tensor([r[word] for r in rows], dtype=torch.int64, device=dev)
        return bits.view(torch.float64).repeat_interleave(
            torch.tensor([r[1].numel() for r in rows], device=dev))

    cols = out[HEADER_WORDS * p_n :].view(torch.float64).view(ncols, nrows) if ncols else None
    if code == 0:
        for c, x in enumerate(segment_agg_plain(*(t[:, None] for t in (theta, slope, a.double(),
                                                                       b.double())))):
            cols[c, pos] = x[:, 0]
    elif code == 1:
        m = (b - a).double()
        ibar = _div((a + b - 1).double(), 2.0)
        dev_ = theta + slope * ibar - per_row(5)
        cols[0, pos] = _div(slope * slope * m * (m * m - 1.0), 12.0) + m * (dev_ * dev_)
    else:
        for w, word in ((2, 5), (3, 6)):
            n = _count(theta, slope, a, b, per_row(word), op)
            hdr[:, w] = torch.zeros(p_n, dtype=torch.int64, device=dev).index_add_(0, part, n)
    return out


_Q_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
           ctypes.c_void_p, ctypes.c_void_p]


def segment_query_cuda(tables, desc, mode: str, op: str, nrows: int) -> torch.Tensor:
    """Launch ``csrc/segment_agg.cu``'s ``segment_query``; same contract as
    :func:`segment_query_plain`.  The kernel reads each table through the
    address in its descriptor: ``tables`` must stay alive until the step's
    output has been read.  It writes every header word and each part's
    rows; the rest of the row columns is left as it was allocated."""
    code, ncols = MODES[mode]
    if desc.dtype != torch.int64 or desc.ndim != 2 or desc.shape[1] != DESC_WORDS:
        raise ValueError(f"segment_query: desc must be int64 [P, {DESC_WORDS}]")
    if any(t.device != desc.device or t.dtype != torch.int64 for t in tables):
        raise ValueError(f"segment_query: tables must be int64 on {desc.device}")
    desc = desc.contiguous()
    p_n = desc.shape[0]
    out = torch.empty(HEADER_WORDS * p_n + ncols * nrows, dtype=torch.int64, device=desc.device)
    if p_n:
        fn = _build.function("segment_agg", "segment_query", _Q_ARGS)
        with torch.cuda.device(desc.device):
            rc = fn(desc.data_ptr(), p_n, code, CMP_CODES[op], nrows, out.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
        _build.check(rc, "segment_query")
        _build.launches["segment_query"] += 1
    return out


def segment_query(tables, desc, mode: str, op: str, nrows: int) -> torch.Tensor:
    """The wrapper: the kernel for a CUDA ``desc``, the plain version for a
    CPU one.  ``op`` is the comparison of a ``"count"`` step; ``nrows``
    sizes the row columns (the host's bound on the parts' rows, each
    part's offset in ``desc``)."""
    if mode not in MODES:
        raise ValueError(f"segment_query: unknown mode {mode!r}")
    if op not in CMP_CODES:
        raise ValueError(f"unknown comparison {op!r}: expected one of {tuple(CMP_CODES)}")
    if desc.is_cuda:
        return segment_query_cuda(tables, desc, mode, op, nrows)
    if desc.device.type != "cpu":
        raise ValueError(f"segment_query runs on cuda or cpu, got {desc.device}")
    return segment_query_plain(tables, desc, mode, op, nrows)


def query_parts(out: np.ndarray, desc: np.ndarray, mode: str, nrows: int):
    """A step's output buffer (host int64) as one tuple a part:
    (i0, i1, count at f1, count at f2, rows [C, i1 - i0] float64)."""
    p_n = desc.shape[0]
    ncols = MODES[mode][1]
    hdr = out[: HEADER_WORDS * p_n].reshape(p_n, HEADER_WORDS)
    cols = out[HEADER_WORDS * p_n :].view(np.float64).reshape(ncols, nrows)
    res = []
    for p in range(p_n):
        i0, i1, c1, c2 = (int(x) for x in hdr[p])
        off = int(desc[p, 4])
        res.append((i0, i1, c1, c2, cols[:, off : off + i1 - i0]))
    return res
