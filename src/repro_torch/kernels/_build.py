"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, and loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -shared -Xcompiler -fPIC -o lib<name>-<hash>.so csrc/<name>.cu

``--fmad=false`` keeps every multiply and add separate, which the exact
float64 paths need.  Libraries land in ``build/repro_torch_kernels/`` at
the repository root, named by a hash of the source, of every shared header
``csrc/*.cuh`` (which a source may include) and of the flags, so an edited
source or header is rebuilt.  Each C entry point returns
``cudaGetLastError()`` after its launch; :func:`check` raises when that is
not 0.

``launches`` counts the launches of each kernel: a wrapper adds one where
it launches its kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

__all__ = ["KERNELS", "build_all", "check", "function", "launches", "reset_launches"]

KERNELS = (
    "cone_scan", "rans", "residual_quant", "dequant", "base_fit", "segment_agg", "flash_attention",
    "interval_stats", "pyramid_quant", "pyramid_reconstruct", "flash_attention_bwd",
)
CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
]

launches: dict[str, int] = {
    "cone_scan": 0, "rans_encode": 0, "rans_decode": 0, "residual_quant": 0, "dequant": 0,
    "base_fit": 0, "segment_agg": 0, "segment_query": 0, "flash_attention": 0,
    "interval_stats": 0, "pyramid_quant": 0, "pyramid_reconstruct": 0, "flash_attention_bwd": 0,
}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _lib_path(name: str) -> pathlib.Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str) -> tuple[pathlib.Path, pathlib.Path, subprocess.Popen] | None:
    """Start nvcc for one source unless its library is already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish(name: str, job) -> None:
    if job is None:
        return
    out, tmp, proc = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: concurrent builders never load a partial file


def build_all() -> None:
    """Compile every kernel source, one nvcc process each, all at once."""
    jobs = {name: _start(name) for name in KERNELS}
    for name, job in jobs.items():
        _finish(name, job)


def _library(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib


def function(lib: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of library ``lib``, typed: every pointer
    and the stream as ``c_void_p``, so ctypes never cuts them to 32 bits."""
    fn = getattr(_library(lib), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")
