"""Where the port builds its CUDA kernels, on the CPU (no ``nvcc`` needed:
the choice of directory is tested, not the compile).  ``_kernels`` builds
into the package's ``_build/`` where it may write (a checkout), else into
the per-user cache, ``$XDG_CACHE_HOME/obs_color_monitor_tpu_torch/`` or
``~/.cache/obs_color_monitor_tpu_torch/``, and raises, naming both, where
it can write neither: it never falls back to the plain versions.  A
library of the present sources already in either place is loaded from
there, writable or not.  A directory without a write bit is read-only here
even for root."""

import os
import stat
from pathlib import Path

import pytest

from obs_color_monitor_tpu_torch import _kernels

PKG = "obs_color_monitor_tpu_torch"


@pytest.fixture
def dirs(tmp_path, monkeypatch):
    """A package directory and a cache root under ``tmp_path``, both
    writable; ``BUILD_DIR`` and ``XDG_CACHE_HOME`` point at them.  Every
    mode is restored afterwards."""
    pkg, cache = tmp_path / "site" / PKG, tmp_path / "cache"
    pkg.mkdir(parents=True)
    cache.mkdir()
    monkeypatch.setattr(_kernels, "BUILD_DIR", pkg / "_build")
    monkeypatch.setenv("XDG_CACHE_HOME", str(cache))
    yield pkg, cache
    for d, _, _ in os.walk(tmp_path):
        os.chmod(d, 0o755)


def _read_only(d):
    os.chmod(d, stat.S_IRUSR | stat.S_IXUSR | stat.S_IRGRP | stat.S_IXGRP | stat.S_IROTH
             | stat.S_IXOTH)


def test_a_writable_package_builds_in_place(dirs):
    pkg, _ = dirs
    assert _kernels.build_dir() == pkg / "_build"
    assert _kernels._lib_path() == pkg / "_build" / f"libocm_kernels_{_kernels.source_hash()}.so"


@pytest.mark.parametrize("which", ["package", "build dir"])
def test_a_read_only_package_builds_in_the_cache(dirs, which):
    pkg, cache = dirs
    if which == "build dir":
        (pkg / "_build").mkdir()
        _read_only(pkg / "_build")
    else:
        _read_only(pkg)
    want = cache / PKG
    assert _kernels.cache_dir() == want
    assert _kernels.build_dir() == want
    assert _kernels._lib_path() == want / f"libocm_kernels_{_kernels.source_hash()}.so"
    assert not _kernels.built()


def test_the_cache_defaults_to_home(dirs, monkeypatch, tmp_path):
    pkg, _ = dirs
    _read_only(pkg)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    for value in (None, "", "relative/cache"):  # unset or not absolute: ignored
        if value is None:
            monkeypatch.delenv("XDG_CACHE_HOME")
        else:
            monkeypatch.setenv("XDG_CACHE_HOME", value)
        assert _kernels.build_dir() == tmp_path / "home" / ".cache" / PKG


def test_neither_writable_raises_naming_both(dirs):
    pkg, cache = dirs
    _read_only(pkg)
    _read_only(cache)
    for call in (_kernels.build_dir, _kernels.build):
        with pytest.raises(RuntimeError) as e:
            call()
        assert str(pkg / "_build") in str(e.value) and str(cache / PKG) in str(e.value)
    assert not _kernels.built()


@pytest.mark.parametrize("where", ["read-only build dir", "cache"])
def test_a_prebuilt_library_is_used_where_it_lies(dirs, monkeypatch, where):
    """A library of this source hash already built is loaded from where it
    lies (a read-only ``_build/`` included) and is never built again."""
    pkg, cache = dirs
    name = f"libocm_kernels_{_kernels.source_hash()}.so"
    d = pkg / "_build" if where == "read-only build dir" else cache / PKG
    d.mkdir(parents=True)
    (d / name).write_bytes(b"")
    if where == "read-only build dir":
        _read_only(d)
        _read_only(pkg)
        _read_only(cache)  # nothing can be written anywhere

    def no_nvcc():
        raise AssertionError("built again")

    monkeypatch.setattr(_kernels, "_nvcc", no_nvcc)
    assert _kernels._lib_path() == d / name
    assert _kernels.built()
    assert _kernels.build() == d / name


def test_the_build_dir_is_the_packages():
    """A checkout builds into its own gitignored ``_build/``."""
    assert _kernels.BUILD_DIR == Path(_kernels.__file__).parent / "_build"
