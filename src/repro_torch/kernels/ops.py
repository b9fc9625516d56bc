"""Public entry points of the port's kernels (counterpart of
``repro.kernels.ops``).

Every wrapper here launches its hand-written CUDA kernel when given CUDA
tensors and runs the kernel's plain torch version when given CPU tensors;
nothing else chooses between them.  ``launches`` counts kernel launches
by name and ``reset_launches`` zeroes the counts.  The names and argument
orders are the reference's, without its ``force_ref`` switch (the
tensor's device picks the route): ``interval_stats(x, window)``,
``pyramid_quant(x, theta, slope, steps, qmax=127, lengths=None)``,
``pyramid_reconstruct(qs, theta, slope, steps)`` and the rest.
``rans_encode_rows`` and ``rans_decode_rows`` keep the reference's numpy
row contract (their ``route`` is accepted and ignored); the codec calls
the device row functions of ``kernels.rans`` directly.

The cone scan needs no block padding: the kernel loops over all T steps
inside each thread, where the TPU kernel needed T to be a multiple of its
time block.  ``compact_segments`` turns its dense per-point outputs into
per-series segment records with torch ops, as ``_compact_segments`` did in
XLA.
"""
from __future__ import annotations

import numpy as np
import torch

from . import rans as _rans
from ._build import launches, reset_launches
from .base_fit import base_fit
from .cone_scan import cone_scan
from .dequant import dequant, pyramid_reconstruct
from .flash_attention import flash_attention
from .interval_stats import interval_stats
from .rans import ID_SYM as RANS_ID_SYM
from .residual_quant import pyramid_quant, residual_quant
from .segment_agg import segment_agg, segment_query

__all__ = [
    "base_fit",
    "compact_segments",
    "cone_scan",
    "cone_scan_segments",
    "dequant",
    "dequant_reconstruct",
    "flash_attention",
    "interval_stats",
    "launches",
    "pyramid_quant",
    "pyramid_reconstruct",
    "RANS_ID_SYM",
    "rans_decode_rows",
    "rans_encode_rows",
    "reset_launches",
    "residual_quant",
    "segment_agg",
    "segment_query",
]

_LANES = 64  # the reference's interleaved rANS states a row (``_K``)


def rans_encode_rows(sym_mat, freqs, route: str = "auto", *, device=None):
    """The reference's row encoder: ``sym_mat[R, cols]`` symbols in [0, 256]
    (256 pads short rows) and ``freqs[R, 256]`` normalized tables, as
    numpy arrays, through the ``rans_encode`` kernel on ``device`` (default
    the card).  Returns (states[R, 64] uint32, each row's uint16 words in
    decoder order).  ``route`` is the reference's route switch, ignored."""
    from ..core.device import resolve_device

    dev = resolve_device(device)
    sym = torch.as_tensor(np.asarray(sym_mat, dtype=np.int16), device=dev)
    f = torch.as_tensor(np.asarray(freqs, dtype=np.int64), device=dev)
    states, words, counts = _rans.encode_rows(sym, f, _LANES)
    words = words.cpu().numpy().view(np.uint16)
    cut = np.cumsum(counts.cpu().numpy())[:-1]
    return states.cpu().numpy().astype(np.uint32), np.split(words, cut) if len(counts) else []


def rans_decode_rows(states, freqs, words: list, n: int, route: str = "auto", *, device=None):
    """The reference's row decoder: R rows of ``n`` symbols from their
    final ``states[R, 64]``, ``freqs[R, 256]`` and word streams (numpy),
    through the ``rans_decode`` kernel on ``device`` (default the card).
    Returns syms[R, n] uint8.  ``route`` is ignored, as above."""
    from ..core.device import resolve_device

    dev = resolve_device(device)
    r = len(states)
    cnt = np.array([len(w) for w in words], dtype=np.int64)
    off = np.concatenate([[0], np.cumsum(cnt)[:-1]]).astype(np.int64)
    flat = np.concatenate([np.asarray(w, dtype=np.uint16) for w in words]) if r else \
        np.zeros(0, np.uint16)
    steps = -(-int(n) // _LANES)
    args = [torch.as_tensor(np.asarray(a), device=dev) for a in (
        np.asarray(states, dtype=np.int64), np.asarray(freqs, dtype=np.int64),
        flat.view(np.int16), off, cnt, np.full(r, int(n), dtype=np.int64))]
    syms, _ = _rans.decode_rows(*args, _LANES, cols=steps * _LANES)
    return syms[:, : int(n)].cpu().numpy()


def compact_segments(brk, theta, psi_lo, psi_hi, fin_lo, fin_hi):
    """Dense scan outputs [T, S] -> per-series segment records.

    Returns (counts[S], t0s[T, S], thetas[T, S], lo[T, S], hi[T, S]): row k
    of each [T, S] output is segment k of that series (rows >= counts[s] are
    zero padding).  A break at t starts segment cumsum(brk)[t] - 1 and
    carries the span of the one before it; the still-open segment's span is
    the final carry.
    """
    t_len, s = brk.shape
    dev = brk.device
    seg = torch.cumsum(brk, dim=0, dtype=torch.int64) - 1
    is_brk = brk.bool()
    cols = torch.arange(s, device=dev).expand(t_len, s)
    tpos = torch.arange(t_len, dtype=torch.int32, device=dev)[:, None].expand(t_len, s)
    # non-break positions scatter into a dump row at index T
    rows = torch.where(is_brk, seg, t_len)
    t0s = torch.zeros((t_len + 1, s), dtype=torch.int32, device=dev)
    t0s.index_put_((rows, cols), tpos)
    thetas = torch.zeros((t_len + 1, s), dtype=theta.dtype, device=dev)
    thetas.index_put_((rows, cols), theta)
    close = torch.where(is_brk & (seg > 0), seg - 1, t_len)
    lo = torch.zeros((t_len + 1, s), dtype=psi_lo.dtype, device=dev)
    lo.index_put_((close, cols), psi_lo)
    hi = torch.zeros((t_len + 1, s), dtype=psi_hi.dtype, device=dev)
    hi.index_put_((close, cols), psi_hi)
    counts = brk.sum(dim=0, dtype=torch.int64)
    lanes = torch.arange(s, device=dev)
    lo[counts - 1, lanes] = fin_lo.reshape(s)
    hi[counts - 1, lanes] = fin_hi.reshape(s)
    return counts, t0s[:t_len], thetas[:t_len], lo[:t_len], hi[:t_len]


def cone_scan_segments(x, eps_hat, lengths=None):
    """The cone scan followed by :func:`compact_segments`: x[T, S],
    eps_hat[T, S] -> (counts[S], t0s, thetas, psi_lo, psi_hi [T, S]).
    Unbounded spans stay +-inf (the Pallas route used +-3.4e38)."""
    return compact_segments(*cone_scan(x, eps_hat, lengths))


def dequant_reconstruct(q, theta, slope, step):
    """The reference's name for :func:`dequant`."""
    return dequant(q, theta, slope, step)
