"""Every comparator in the paper's evaluation, counterpart of
``repro.baselines``.

Lossy (error-bounded):  Sim-Piece, APCA, LFZip, HIRE
Lossless:               GZip, BZip2, zstd, TRC, Gorilla, GD

Uniform registry interface for the benchmark harness, under the
reference's keys:

    LOSSY[name](values, eps)          -> bytes
    LOSSY_D[name](blob)               -> values
    LOSSLESS[name](values, decimals)  -> bytes
    LOSSLESS_D[name](blob)            -> values

Every blob is byte for byte the reference's, and every decode bit for bit.
``values`` is a tensor (on any device) or an ndarray; a decoder returns a
float64 tensor on the card unless given ``device="cpu"``.  The sequential
coders (Gorilla's XOR stream, the Sim-Piece, APCA and HIRE segmenters,
LFZip's NLMS predictor) run on the host in the reference's float order;
GD's integers and width scan, the fixed-width bit packing, TRC's byte
planes and the decoders' reconstructions are torch ops on the values'
device, and the entropy stages go through ``core.entropy`` (TRC's rANS
planes launch ``rans_encode`` and ``rans_decode`` on the card).  zstd is
registered only where the optional ``zstandard`` package imports.
"""
from __future__ import annotations

from . import apca, gd, gorilla, hire, lfzip, simpiece, standard

__all__ = ["LOSSY", "LOSSY_D", "LOSSLESS", "LOSSLESS_D"]

LOSSY = {
    "SimPiece": lambda v, eps: simpiece.compress(v, eps),
    "APCA": lambda v, eps: apca.compress(v, eps),
    "LFZip": lambda v, eps: lfzip.compress(v, eps),
    "HIRE": lambda v, eps: hire.compress(v, eps),
}

LOSSY_D = {
    "SimPiece": simpiece.decompress,
    "APCA": apca.decompress,
    "LFZip": lfzip.decompress,
    "HIRE": hire.decompress,
}

LOSSLESS = {
    "GZip": lambda v, d: standard.gzip_c.compress(v),
    "BZip2": lambda v, d: standard.bzip2_c.compress(v),
    "TRC": lambda v, d: standard.trc_c.compress(v),
    "Gorilla": lambda v, d: gorilla.compress(v),
    "GD": lambda v, d: gd.compress(v, d),
}

LOSSLESS_D = {
    "GZip": standard.gzip_c.decompress,
    "BZip2": standard.bzip2_c.decompress,
    "TRC": standard.trc_c.decompress,
    "Gorilla": gorilla.decompress,
    "GD": gd.decompress,
}

# zstd rides only when the optional dependency is installed; TRC falls back
# to its rANS entropy stage on its own, so it stays unconditional.
if standard._zstd is not None:
    LOSSLESS["zstd"] = lambda v, d: standard.zstd_c.compress(v)
    LOSSLESS_D["zstd"] = standard.zstd_c.decompress
