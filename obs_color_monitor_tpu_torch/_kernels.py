"""Build and load the package's hand-written CUDA kernels.

No JAX counterpart: this stands in for the Mosaic compile that
``pl.pallas_call`` performs.  Every ``.cu``/``.cuh`` file under
``ops/csrc/`` is compiled by ``nvcc`` into ONE shared library with a plain
C interface (no PyTorch headers, so the build takes seconds), loaded with
``ctypes``.  Each ``.cu`` compiles in its own ``nvcc`` process, all started
together, and one more links the objects.  The build runs at first use and
is keyed on a hash of the sources: an edited kernel rebuilds, an unchanged
one loads the existing library.  It writes into ``_build/`` next to this
file where it may (a checkout), else into the per-user cache,
``$XDG_CACHE_HOME/obs_color_monitor_tpu_torch/`` (``~/.cache`` without the
variable): an installed package is often read-only to the user who runs it.
A library of the present sources already in either place is loaded from
there, writable or not.

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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_VP = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# C entry point -> argtypes (every pointer and the stream as c_void_p: a
# plain int argument would be passed as 32 bits and cut the address)
_SIGNATURES = {
    "ocm_frame_pass": [_VP, _VP, _VP, _VP, _I, _VP, _VP, _VP, _VP, _VP, _VP],
    "ocm_scope_stats": [_VP, _VP, _VP, _VP, _LL, _VP, _VP, _I, _I, _VP, _VP, _VP,
                        _I, _I, _I, _LL, _LL, _LL, _LL, _VP],
    "ocm_fused_overlays": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP],
    "ocm_nv12_decode": [_VP, _VP, _I, _I, _I, _I, _I, _I, _I, _VP, _VP],
    "ocm_nv12_16_decode": [_VP, _VP, _I, _I, _I, _I, _I, _I, _I, _I, _VP, _VP],
    "ocm_dock_compose": [_VP, _I, _VP, _VP, _VP],
    "ocm_scope_render": [_VP, _I, _VP],
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


def _run_all(cmds: list[list[str]], verbose: bool) -> None:
    """Run the commands in parallel; raise on the first that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    try:
        for cmd, proc in zip(cmds, procs):
            out, _ = proc.communicate(timeout=900)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
            if verbose:
                print(out, flush=True)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def cache_dir() -> Path:
    """The per-user cache the library is built into when ``BUILD_DIR``
    cannot be written."""
    base = os.environ.get("XDG_CACHE_HOME", "")
    root = Path(base) if os.path.isabs(base) else Path.home() / ".cache"
    return root / "obs_color_monitor_tpu_torch"


def _writable(d: Path) -> bool:
    """Whether a build may write ``d``: its nearest existing directory
    grants writing.  A directory without a write bit counts as read-only
    for root too, whom ``os.access`` alone lets write anywhere."""
    while not d.exists():
        if d.parent == d:
            return False
        d = d.parent
    return d.is_dir() and os.access(d, os.W_OK | os.X_OK) and bool(d.stat().st_mode & 0o222)


def build_dir() -> Path:
    """Where the library is built: ``BUILD_DIR`` where it may be written,
    else :func:`cache_dir`; neither raises, naming both."""
    for d in (BUILD_DIR, cache_dir()):
        if _writable(d):
            return d
    raise RuntimeError(f"cannot build the CUDA kernels: neither {BUILD_DIR} nor {cache_dir()} "
                       "can be written")


def _lib_path() -> Path:
    """The library of the present sources: where ``BUILD_DIR`` or
    :func:`cache_dir` already holds it (a read-only one too), else in
    :func:`build_dir`."""
    name = f"libocm_kernels_{source_hash()}.so"
    for d in (BUILD_DIR, cache_dir()):
        if (d / name).exists():
            return d / name
    return build_dir() / name


def built() -> bool:
    """Whether the library of the present sources is built (False where it
    is not and nothing can be written)."""
    try:
        return _lib_path().exists()
    except RuntimeError:
        return False


def build(verbose: bool = False) -> Path:
    """Compile the kernels (if this source hash is not built yet) and return
    the library path.  The library is linked under a temporary name and
    renamed, so a concurrent or interrupted build never leaves a torn file."""
    lib = _lib_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
        objs, cmds = [], []
        for src in _sources():
            if src.suffix != ".cu":
                continue
            obj = os.path.join(tmp, src.stem + ".o")
            objs.append(obj)
            cmds.append([nvcc, *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
                         "-c", str(src), "-o", obj])
        _run_all(cmds, verbose)
        so = os.path.join(tmp, lib.name)
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", so]], False)
        os.replace(so, lib)
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
    """PyTorch's current stream on ``device``, as the raw cudaStream_t
    (read without building a ``torch.cuda.Stream`` where the build has the
    raw accessor: a wrapper's host time counts on host-bound steps)."""
    import torch

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None and device.index is not None:
        return raw(device.index)
    return torch.cuda.current_stream(device).cuda_stream

