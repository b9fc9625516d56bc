"""Checkpoints with SHRINK compression, counterpart of
``repro.training.checkpoint``, in the reference's layout so that each
package loads the other's:

    <dir>/step_<N>/manifest.json        leaf shapes, dtypes, codecs
    <dir>/step_<N>/leaf_<i>.bin         one blob per leaf, JAX's leaf order
    <dir>/LATEST                        the pointer, written last

(written into ``.tmp_step_<N>`` and renamed).  Codecs per leaf:

    none            raw little-endian bytes
    zstd            zstd of the raw bytes (bit-exact)
    shrink:<frac>   SHRINK lossy with eps = frac x the leaf's value range,
                    by the ported ``ShrinkCodec`` on the leaf's device

The ``leaf_<i>.bin`` files are the reference's bytes; the manifest's
``treedef`` is this package's description of the tree.  bf16 leaves are
written from their int16 view and read back as int16 viewed as bf16 (no
``ml_dtypes``), with the reference's meta (``"dtype": "bfloat16"``,
``"bf16": true``).  Where ``shrink`` sends a leaf of under 1024 elements
or of zero range to ``zstd`` and ``zstandard`` does not import, the leaf
is written raw with codec ``none`` (the reference raises there).

``load_checkpoint``'s ``shardings`` is a tree whose leaves are None (the
leaf lands where its ``like`` leaf is: its device, or a DTensor's mesh and
placements), a ``torch.device``, or a ``parallel.partition.MeshSharding``
(``param_shardings``' leaves: a DeviceMesh and its placements), which
restores the leaf as a DTensor on that mesh, each rank keeping its own
piece; the mesh may differ from the one that saved (an elastic restart:
``make_train_step`` on the new mesh trains on those pieces).
A save copies the leaves to the host first (a DTensor whole, one leaf at
a time, which is a collective: every rank calls it, and ``write=False``
gathers without keeping or writing anything, the ranks other than the one
that writes) and can write in a background thread.  The bytes on disk do
not depend on where a leaf lived, so a sharded step's state is written as
one device's.
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

try:
    import zstandard as _zstd
except Exception:  # pragma: no cover
    _zstd = None

from torch.distributed.tensor import DTensor

from ..core.shrink import ShrinkCodec, cs_from_bytes, cs_to_bytes
from ..parallel.partition import MeshSharding
from ..parallel.sharding import place
from ._tree import leaves, unflatten

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "latest_step",
    "CheckpointManager",
    "default_codec",
]


def default_codec() -> str:
    """Best exact leaf codec available: ``zstd`` when the optional
    ``zstandard`` extra is installed, raw bytes otherwise."""
    return "zstd" if _zstd is not None else "none"


def _host(x: torch.Tensor) -> np.ndarray:
    """The leaf's bytes on the host: bf16 as its int16 view."""
    if isinstance(x, DTensor):
        x = x.full_tensor()
    x = x.detach().cpu().contiguous()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy()
    return x.numpy()


def _encode_leaf(arr: np.ndarray, bf16: bool, codec: str, device) -> tuple[bytes, dict]:
    meta = {"shape": list(arr.shape), "dtype": "bfloat16" if bf16 else str(arr.dtype),
            "codec": codec}
    if bf16:
        meta["bf16"] = True
    raw = arr.tobytes()
    if codec == "none":
        return raw, meta
    if codec == "zstd":
        if _zstd is None:
            raise RuntimeError("zstandard unavailable")
        return _zstd.ZstdCompressor(level=10).compress(raw), meta
    if codec.startswith("shrink:"):
        frac = float(codec.split(":", 1)[1])
        vals = torch.from_numpy(arr).view(torch.bfloat16).float().numpy() if bf16 else arr
        flat = np.asarray(vals, dtype=np.float64).reshape(-1)
        rng = float(flat.max() - flat.min()) if flat.size else 0.0
        if flat.size < 1024 or rng <= 0:
            meta["codec"] = default_codec()
            return _encode_leaf(arr, bf16, meta["codec"], device)[0], meta
        eps = max(frac * rng, 1e-12)
        # zstd when installed (the reference's choice), rans otherwise
        sc = ShrinkCodec.from_fraction(
            flat, frac=0.05, backend="zstd" if _zstd is not None else "rans", device=device
        )
        cs = sc.compress(flat, eps_targets=[eps])
        meta["eps"] = eps
        return cs_to_bytes(cs), meta
    raise ValueError(f"unknown codec {codec!r}")


def _decode_leaf(blob: bytes, meta: dict, device) -> torch.Tensor:
    codec = meta["codec"]
    shape = tuple(meta["shape"])
    if codec == "none" or codec == "zstd":
        raw = blob if codec == "none" else _zstd.ZstdDecompressor().decompress(blob)
        if meta.get("bf16"):
            t = torch.from_numpy(np.frombuffer(raw, dtype=np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.frombuffer(raw, dtype=np.dtype(meta["dtype"])).copy())
        return t.reshape(shape).to(device)
    if codec.startswith("shrink:") or "eps" in meta:
        cs = cs_from_bytes(blob)
        sc = ShrinkCodec.from_fraction(np.zeros(2), frac=0.05, device=device)
        vals = sc.decompress_at(cs, meta["eps"])
        # as the reference: a bf16 leaf comes back as float32
        dtype = torch.float32 if meta.get("bf16") else getattr(torch, meta["dtype"])
        return vals.to(dtype).reshape(shape)
    raise ValueError(f"bad leaf meta {meta}")


def _treedef(state) -> str:
    if isinstance(state, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(state[k])}" for k in sorted(state)) + "}"
    if isinstance(state, (list, tuple)):
        return "[" + ", ".join(_treedef(t) for t in state) + "]"
    return "None" if state is None else "*"


def save_checkpoint(
    directory: str | Path,
    step: int,
    state: Any,
    codec: str | None = None,
    asynchronous: bool = False,
    write: bool = True,
) -> threading.Thread | None:
    """Snapshot `state` (a tree of tensors) at `step`.  Returns the writer
    thread when asynchronous.  ``codec=None`` picks :func:`default_codec`.
    ``write=False``: only gather the DTensor leaves (the collectives of a
    save on a rank that does not write) and return None."""
    directory = Path(directory)
    if codec is None:
        codec = default_codec()
    flat = leaves(state)
    if not write:
        for x in flat:
            if isinstance(x, DTensor):
                x.full_tensor()
        return None
    snap = [(_host(x), x.dtype == torch.bfloat16, x.device) for x in flat]
    treedef = _treedef(state)

    def write() -> None:
        tmp = directory / f".tmp_step_{step}"
        final = directory / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        metas = []
        for i, (arr, bf16, dev) in enumerate(snap):
            blob, meta = _encode_leaf(arr, bf16, codec, dev)
            (tmp / f"leaf_{i}.bin").write_bytes(blob)
            metas.append(meta)
        (tmp / "manifest.json").write_text(
            json.dumps({"step": step, "treedef": treedef, "leaves": metas})
        )
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        (directory / "LATEST").write_text(str(step))

    if asynchronous:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    return None


def latest_step(directory: str | Path) -> Optional[int]:
    p = Path(directory) / "LATEST"
    if not p.exists():
        return None
    return int(p.read_text().strip())


def load_checkpoint(
    directory: str | Path,
    like: Any,
    step: Optional[int] = None,
    shardings: Any = None,
) -> tuple[Any, int]:
    """Restore into the structure of `like`.  `shardings` (optional tree of
    ``torch.device``s and ``MeshSharding``s, or None) places each leaf; by
    default each leaf lands where its ``like`` leaf is."""
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    d = directory / f"step_{step}"
    manifest = json.loads((d / "manifest.json").read_text())
    leaves_meta = manifest["leaves"]
    like_leaves = leaves(like)
    n = len(like_leaves)
    if n != len(leaves_meta):
        raise ValueError(f"leaf count mismatch: {n} vs {len(leaves_meta)}")
    targets = _targets(shardings, like)
    out = []
    for i, meta in enumerate(leaves_meta):
        target, like_leaf = targets[i], like_leaves[i]
        if target is None and isinstance(like_leaf, DTensor):
            target = MeshSharding(like_leaf.device_mesh, like_leaf.placements)
        blob = (d / f"leaf_{i}.bin").read_bytes()
        if isinstance(target, MeshSharding):
            out.append(place(_decode_leaf(blob, meta, _mesh_device(target.mesh)), *target))
        else:
            dev = target if target is not None else like_leaf.device
            out.append(_decode_leaf(blob, meta, torch.device(dev)))
    return unflatten(like, out), step


def _targets(shardings, like) -> list:
    """One target a leaf of ``like``, in its leaf order: ``shardings``
    follows ``like``'s structure, and None there (a subtree's or a leaf's)
    places nothing."""
    if shardings is None:
        return [None] * len(leaves(like))
    if isinstance(like, dict):
        return [t for k in sorted(like) for t in _targets(shardings[k], like[k])]
    if isinstance(like, (list, tuple)):
        return [t for s, x in zip(shardings, like, strict=True) for t in _targets(s, x)]
    return [] if like is None else [shardings]


def _mesh_device(mesh) -> torch.device:
    """This rank's device of ``mesh``: the current card of a cuda mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


class CheckpointManager:
    """keep_n rotation + async handles + resume helper."""

    def __init__(self, directory: str | Path, keep_n: int = 3, codec: str | None = None):
        self.dir = Path(directory)
        self.keep_n = keep_n
        self.codec = codec if codec is not None else default_codec()
        self._pending: list[threading.Thread] = []

    def save(self, step: int, state: Any, asynchronous: bool = True, write: bool = True) -> None:
        t = save_checkpoint(self.dir, step, state, codec=self.codec, asynchronous=asynchronous,
                            write=write)
        if t:
            self._pending.append(t)
        if write:
            self._gc()

    def wait(self) -> None:
        for t in self._pending:
            t.join()
        self._pending.clear()
        self._gc()  # async writes may have landed after the save-time GC

    def restore(self, like: Any, shardings: Any = None):
        return load_checkpoint(self.dir, like, shardings=shardings)

    def _gc(self) -> None:
        steps = sorted(
            int(p.name.split("_")[1]) for p in self.dir.glob("step_*") if p.is_dir()
        )
        for s in steps[: -self.keep_n]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)
