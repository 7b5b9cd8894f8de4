"""The port's systemd unit (``packaging/obs-color-monitor-tpu-torch.service``)
held to the port's CLI and to the JAX package's unit, and its chip_smoke
phase rehearsed on the CPU at a small size."""

from pathlib import Path

import pytest
import torch

import chip_smoke

ROOT = Path(__file__).resolve().parents[1]
PORT_UNIT = ROOT / chip_smoke.SERVICE_UNIT
JAX_UNIT = ROOT / "packaging" / "obs-color-monitor-tpu.service"


def _options(args: list) -> list:
    """The ``--flag`` names of an argument list, in order."""
    return [a for a in args if a.startswith("--")]


def test_unit_command_parses_with_the_port_cli():
    """Every option of the unit's ExecStart is one the port's CLI takes,
    with the values the service means: the dock on a raw 4K RGBA capture,
    on the card."""
    from obs_color_monitor_tpu_torch.__main__ import _parser

    argv = chip_smoke.unit_command(PORT_UNIT)
    assert Path(argv[0]).name == "obs-color-monitor-tpu-torch"
    args = _parser().parse_args(argv[1:])
    assert args.cmd == "dock" and args.device == "cuda"
    assert args.input.endswith(".rgba") and args.out.endswith(".png")
    assert (args.size, args.frames) == ("3840x2160", 600)


def test_unit_command_is_the_jax_units():
    """The options (and their values) equal the JAX unit's, but for the
    script's name and the appended ``--device cuda``."""
    port, jax = chip_smoke.unit_command(PORT_UNIT), chip_smoke.unit_command(JAX_UNIT)
    assert Path(jax[0]).name == "obs-color-monitor-tpu"
    assert port[1:] == jax[1:] + ["--device", "cuda"]
    assert _options(port[1:]) == _options(jax[1:]) + ["--device"]


def test_unit_sets_no_jax_platform():
    text = PORT_UNIT.read_text()
    assert "JAX_PLATFORMS" not in text and "jax" not in text.lower()
    assert "JAX_PLATFORMS" in JAX_UNIT.read_text()


def test_unit_args_point_paths_size_and_device(tmp_path):
    argv = chip_smoke.unit_command(PORT_UNIT)
    args = chip_smoke.unit_args(argv[1:], tmp_path / "f.rgba", tmp_path / "p.png", 48, 64,
                                torch.device("cpu"))
    assert args == ["dock", "--input", str(tmp_path / "f.rgba"), "--size", "64x48",
                    "--frames", "600", "--out", str(tmp_path / "p.png"), "--device", "cpu"]


def test_unit_phase_on_the_cpu():
    """chip_smoke's service-unit phase at 48x64 on the CPU: the unit's
    command in process on an 8-frame RGBA file, its PNG equal to a directly
    driven Dock's panel (the phase raises otherwise); no launch counted."""
    torch.set_num_threads(1)
    by_path, png = chip_smoke.phase_service_unit(torch.device("cpu"), h=48, w=64)
    counts = by_path["service unit dock rgba"]
    assert max(counts[k] for k in ("K1", "K2", "K3")) == 0
    assert png.startswith(b"\x89PNG")


def test_unit_phase_refuses_a_wrong_png(monkeypatch):
    """The phase fails when the CLI's panel is not the directly driven
    Dock's (here that Dock's panel is one bit off)."""
    import numpy as np

    from obs_color_monitor_tpu_torch.models import Dock

    torch.set_num_threads(1)
    render, calls = Dock.render, []

    def second_render_off(self, *a, **k):
        img = np.array(render(self, *a, **k))
        calls.append(1)
        if len(calls) == 2:  # the CLI renders first, the phase's own Dock second
            img[0, 0, 0] ^= 1
        return img

    monkeypatch.setattr(Dock, "render", second_render_off)
    with pytest.raises(AssertionError, match="differs"):
        chip_smoke.phase_service_unit(torch.device("cpu"), h=48, w=64)
    assert len(calls) == 2
