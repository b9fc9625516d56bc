"""Interleaved rANS coder: CUDA kernels, plain versions, wrappers.

Counterpart of ``repro.kernels.rans`` (the Pallas TPU kernels
``_rans_encode_kernel`` / ``rans_encode_pallas`` and
``_rans_decode_kernel`` / ``rans_decode_pallas``).  The machine is
``core.entropy``'s: K <= 64 interleaved 32-bit states, 12-bit
probabilities (M = 4096), 16-bit renormalisation; symbol i of a row
belongs to lane i % K at step i // K.  The encoder walks steps backward
and records per cell whether the lane renormalised (``need``) and the low
16 bits it would emit (``vals``); compacting ``vals[need]`` over a row's
[steps, K] cells gives its word stream in decoder order (steps ascending,
lanes ascending).  The decoder walks steps forward; renormalising lanes
read the row's words in ascending lane order.

The kernels are ``csrc/rans.cu``: the encoder one block a row and one
thread a lane, the decoder one warp a row (a thread owns lanes ``wl`` and
``wl + 32``), each with the row's tables in shared memory.  The plain
versions hold the states in int64 and keep them below 2^32, because
torch's CPU kernels lack unsigned 32-bit shifts, divisions and
comparisons.  Symbols are int16 in [0, 256] (256 is
the identity pad: freq = M, cum = 0, a no-op); words are the u16 wire
words held as int16.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = [
    "decode_rows",
    "decode_rows_cuda",
    "decode_rows_plain",
    "encode_cells",
    "encode_cells_cuda",
    "encode_cells_plain",
    "encode_rows",
]

PROB_BITS = 12
M = 1 << PROB_BITS
L = 1 << 16
K_MAX = 64
ID_SYM = 256


def _to_int16(v: torch.Tensor) -> torch.Tensor:
    """Low 16 bits of non-negative int64 values, as int16 (two's complement)."""
    return (((v & 0xFFFF) ^ 0x8000) - 0x8000).to(torch.int16)


def _cum_tables(freqs: torch.Tensor) -> torch.Tensor:
    c = torch.zeros_like(freqs)
    c[:, 1:] = torch.cumsum(freqs[:, :-1], dim=1)
    return c


def encode_cells_plain(sym: torch.Tensor, freqs: torch.Tensor, k: int):
    """sym[R, steps * k] int16, freqs[R, 256] int64 -> (states[R, k] int64,
    need[R, steps * k] bool, vals[R, steps * k] int16)."""
    r, cols = sym.shape
    steps = cols // k
    dev = sym.device
    ident = torch.full((r, 1), M, dtype=torch.int64, device=dev)
    f_ext = torch.cat([freqs.long(), ident], dim=1)
    c_ext = torch.cat([_cum_tables(freqs.long()), torch.zeros_like(ident)], dim=1)
    idx = sym.long()
    f_all = f_ext.gather(1, idx).view(r, steps, k)
    c_all = c_ext.gather(1, idx).view(r, steps, k)
    need = torch.empty((r, steps, k), dtype=torch.bool, device=dev)
    vals = torch.empty((r, steps, k), dtype=torch.int16, device=dev)
    x = torch.full((r, k), L, dtype=torch.int64, device=dev)
    for t in range(steps - 1, -1, -1):
        f = f_all[:, t]
        nd = x > (f << (32 - PROB_BITS)) - 1
        need[:, t] = nd
        vals[:, t] = _to_int16(x)
        x = torch.where(nd, x >> 16, x)
        x = ((x // f) << PROB_BITS) + x % f + c_all[:, t]
    return x, need.view(r, cols), vals.view(r, cols)


_ENC_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5


def encode_cells_cuda(sym: torch.Tensor, freqs: torch.Tensor, k: int):
    """Launch the encode kernel of ``csrc/rans.cu``; same contract as
    :func:`encode_cells_plain`."""
    r, cols = sym.shape
    if sym.dtype != torch.int16 or freqs.dtype != torch.int64:
        raise TypeError("rans encode takes int16 symbols and int64 freqs")
    if freqs.shape != (r, 256) or freqs.device != sym.device:
        raise ValueError("freqs must be [R, 256] on the symbols' device")
    if not 1 <= k <= K_MAX or cols % k:
        raise ValueError(f"lane count {k} must be in [1, {K_MAX}] and divide {cols}")
    sym = sym.contiguous()
    freqs = freqs.contiguous()
    dev = sym.device
    states = torch.empty((r, k), dtype=torch.int64, device=dev)
    need = torch.empty((r, cols), dtype=torch.bool, device=dev)
    vals = torch.empty((r, cols), dtype=torch.int16, device=dev)
    if r == 0 or cols == 0:
        states.fill_(L)
        return states, need, vals
    fn = _build.function("rans", "rans_encode", _ENC_ARGS)
    with torch.cuda.device(dev):
        err = fn(
            sym.data_ptr(), r, cols, k, freqs.data_ptr(), states.data_ptr(),
            need.data_ptr(), vals.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "rans_encode")
    _build.launches["rans_encode"] += 1
    return states, need, vals


def encode_cells(sym: torch.Tensor, freqs: torch.Tensor, k: int):
    """The encode wrapper: the kernel for a CUDA tensor, the plain version
    for a CPU tensor."""
    if sym.is_cuda:
        return encode_cells_cuda(sym, freqs, k)
    if sym.device.type != "cpu":
        raise ValueError(f"rans encode runs on cuda or cpu, got {sym.device}")
    return encode_cells_plain(sym, freqs, k)


def encode_rows(sym: torch.Tensor, freqs: torch.Tensor, k: int):
    """Encode R symbol rows with their normalized tables.

    sym[R, n] integer symbols in [0, 256] (256 pads short rows), freqs[R, 256]
    (each row sums to M, or is all zero for an empty row).  Pads the rows to
    a whole number of steps with the identity symbol, runs the encoder and
    compacts the words on the device.  Returns (states[R, k] int64, words
    int16 [total] with each row's words contiguous in decoder order,
    counts[R] int64).
    """
    r, n = sym.shape
    steps = -(-n // k) if n else 0
    cells = torch.full((r, steps * k), ID_SYM, dtype=torch.int16, device=sym.device)
    cells[:, :n] = sym
    states, need, vals = encode_cells(cells, freqs.long(), k)
    return states, vals.masked_select(need), need.sum(dim=1)


def _slot_tables(freqs: torch.Tensor) -> torch.Tensor:
    """slot -> symbol map [R, M] of tables that each sum to M."""
    r = freqs.shape[0]
    syms = torch.arange(256, device=freqs.device).repeat(r)
    return torch.repeat_interleave(syms, freqs.reshape(-1)).view(r, M)


def decode_rows_plain(states, freqs, words, word_off, word_cnt, ns, k: int, cols: int):
    """Decode R rows: states[R, k] int64, freqs[R, 256] int64 (rows with
    ns > 0 sum to M), words int16 [W] with row i's words at
    [word_off[i], word_off[i] + word_cnt[i]), ns[R] symbols per row.
    Returns (syms[R, cols] uint8, used[R] int64 words each row asked for)."""
    r = states.shape[0]
    dev = states.device
    ok = (ns > 0)[:, None]
    dummy = torch.zeros_like(freqs)
    dummy[:, 0] = M
    tables = torch.where(ok, freqs, dummy)  # empty rows: any valid table
    s2s = _slot_tables(tables)
    cum = _cum_tables(tables)
    flat = torch.cat([words.long() & 0xFFFF, torch.zeros(1, dtype=torch.int64, device=dev)])
    zero_at = flat.numel() - 1
    x = states.clone()
    pos = torch.zeros(r, dtype=torch.int64, device=dev)
    syms = torch.zeros((r, cols), dtype=torch.uint8, device=dev)
    lanes = torch.arange(k, device=dev)
    steps = int((-(-ns // k)).max()) if r else 0
    for t in range(steps):
        act = (t * k + lanes)[None, :] < ns[:, None]
        slot = x & (M - 1)
        s = s2s.gather(1, slot)
        x2 = tables.gather(1, s) * (x >> PROB_BITS) + slot - cum.gather(1, s)
        nd = (x2 < L) & act
        ndi = nd.long()
        idx = pos[:, None] + torch.cumsum(ndi, dim=1) - ndi
        inside = idx < word_cnt[:, None]
        w = flat[torch.where(inside, word_off[:, None] + idx, zero_at)]
        x2 = torch.where(nd, (x2 << 16) | w, x2)
        x = torch.where(act, x2, x)
        syms[:, t * k : (t + 1) * k] = torch.where(act, s, 0).to(torch.uint8)
        pos = pos + ndi.sum(dim=1)
    return syms, pos


_DEC_ARGS = (
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    + [ctypes.c_void_p] * 5
    + [ctypes.c_int64]
    + [ctypes.c_void_p] * 3
)


def decode_rows_cuda(states, freqs, words, word_off, word_cnt, ns, k: int, cols: int):
    """Launch the decode kernel of ``csrc/rans.cu``; same contract as
    :func:`decode_rows_plain`."""
    r = states.shape[0]
    dev = states.device
    for name, tns, dt in (
        ("states", states, torch.int64), ("freqs", freqs, torch.int64),
        ("words", words, torch.int16), ("word_off", word_off, torch.int64),
        ("word_cnt", word_cnt, torch.int64), ("ns", ns, torch.int64),
    ):
        if tns.dtype != dt or tns.device != dev:
            raise TypeError(f"rans decode: {name} must be {dt} on {dev}")
    if not 1 <= k <= K_MAX or states.shape != (r, k) or freqs.shape != (r, 256):
        raise ValueError("rans decode: states must be [R, k <= 64], freqs [R, 256]")
    states, freqs, words = states.contiguous(), freqs.contiguous(), words.contiguous()
    word_off, word_cnt, ns = word_off.contiguous(), word_cnt.contiguous(), ns.contiguous()
    # the kernel writes every cell (0 past a row's symbols) and every count
    syms = torch.empty((r, cols), dtype=torch.uint8, device=dev)
    used = torch.empty(r, dtype=torch.int64, device=dev)
    if r == 0:
        return syms, used
    fn = _build.function("rans", "rans_decode", _DEC_ARGS)
    with torch.cuda.device(dev):
        err = fn(
            states.data_ptr(), r, k, freqs.data_ptr(), words.data_ptr(),
            word_off.data_ptr(), word_cnt.data_ptr(), ns.data_ptr(), cols,
            syms.data_ptr(), used.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "rans_decode")
    _build.launches["rans_decode"] += 1
    return syms, used


def decode_rows(states, freqs, words, word_off, word_cnt, ns, k: int, cols: int | None = None):
    """The decode wrapper: the kernel for a CUDA tensor, the plain version
    for a CPU tensor.  Returns syms[R, cols] uint8 (row i valid in its first
    ns[i] entries, 0 after them) and used[R], the words each row consumed.

    Without ``cols`` the output has max steps * k columns, found by reading
    ``ns`` back (one synchronization).  The codec's decode path knows the
    lengths on the host and passes ``cols``, which must be at least that
    width.  A smaller ``cols`` raises on the CPU; the kernel cannot see it
    without reading ``ns`` back, so it only keeps its writes inside
    ``cols``: the decode path takes the width from the counts it parsed."""
    r = states.shape[0]
    if cols is None:
        cols = int((-(-ns // k)).max()) * k if r else 0
    if states.is_cuda:
        return decode_rows_cuda(states, freqs, words, word_off, word_cnt, ns, k, cols)
    if states.device.type != "cpu":
        raise ValueError(f"rans decode runs on cuda or cpu, got {states.device}")
    if r and cols < int((-(-ns // k)).max()) * k:
        raise ValueError(f"rans decode: cols {cols} is below the longest row's steps * {k}")
    return decode_rows_plain(states, freqs, words, word_off, word_cnt, ns, k, cols)
