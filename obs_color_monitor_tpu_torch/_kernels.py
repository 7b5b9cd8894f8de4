"""Build and load the package's hand-written CUDA kernels.

No JAX counterpart: this stands in for the Mosaic compile that
``pl.pallas_call`` performs.  Every ``.cu``/``.cuh`` file under
``ops/csrc/`` is compiled by ``nvcc`` into ONE shared library with a plain
C interface (no PyTorch headers, so the build takes seconds), loaded with
``ctypes``.  The build runs at first use, writes into ``_build/`` next to
this file, and is keyed on a hash of the sources: an edited kernel
rebuilds, an unchanged one loads the existing library.

Each C entry point launches on the stream it is given, allocates nothing
and returns ``cudaGetLastError()``; :func:`check` turns a non-zero code into
a ``RuntimeError`` naming the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "ops" / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_VP = ctypes.c_void_p
_I = ctypes.c_int
# C entry point -> argtypes (every pointer and the stream as c_void_p: a
# plain int argument would be passed as 32 bits and cut the address)
_SIGNATURES = {
    "ocm_frame_pass": [_VP, _VP, _VP, ctypes.c_float, _VP, _VP, _VP, _VP, _VP, _VP],
    "ocm_scope_stats": [_VP, _VP, _VP, ctypes.c_longlong, _VP, _I, _I, _VP, _VP, _VP],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def source_hash() -> str:
    """Hash of every kernel source and the nvcc flags (the build key)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build(verbose: bool = False) -> Path:
    """Compile the kernels (if this source hash is not built yet) and return
    the library path.  The library is written to a temporary name and
    renamed, so a concurrent or interrupted build never leaves a torn file."""
    lib = BUILD_DIR / f"libocm_kernels_{source_hash()}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += [str(p) for p in _sources() if p.suffix == ".cu"]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}"
            )
        if verbose:
            print(res.stdout + res.stderr, flush=True)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.ocm_error_string.argtypes = [ctypes.c_int]
            lib.ocm_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if rc != 0:
        msg = library().ocm_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream_handle(device) -> int:
    """PyTorch's current stream on ``device``, as the raw cudaStream_t."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
