"""The port ships the typed marker as the JAX package does: the file
``obs_color_monitor_tpu_torch/py.typed`` exists, ``pyproject.toml`` lists it
in the port's package data (the JAX package's entry keeps its own), and the
wheel built from the project installs it (``chip_smoke.lay_out_package``,
the installed-route phase's own layout, built offline)."""

import tomllib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT, JAX = "obs_color_monitor_tpu_torch", "obs_color_monitor_tpu"


def _package_data() -> dict:
    with open(ROOT / "pyproject.toml", "rb") as f:
        return tomllib.load(f)["tool"]["setuptools"]["package-data"]


@pytest.mark.parametrize("package", [PORT, JAX])
def test_typed_marker_in_the_tree_and_the_package_data(package):
    assert (ROOT / package / "py.typed").is_file()
    assert "py.typed" in _package_data()[package]


def test_wheel_installs_the_typed_marker(tmp_path):
    import chip_smoke

    site, wheel = chip_smoke.lay_out_package(ROOT, tmp_path)
    assert wheel.endswith(".whl")
    for package in (PORT, JAX):
        assert (site / package / "py.typed").is_file(), package
