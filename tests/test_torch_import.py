"""The torch port imports no JAX, nothing of the JAX package, and builds no
kernel on the CPU path."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_PROBE = """
import sys
import numpy as np
import obs_color_monitor_tpu_torch as ocm
step = ocm.make_full_step(24, 40, input_format="packed", device="cpu")
f = np.random.default_rng(0).integers(0, 256, (24, 40, 4), np.uint8)
out = step(ocm.frame_from_numpy(f.view(np.uint32)[..., 0], "packed", "cpu"), 1.0)
assert out.vs_counts.shape == (256, 256)
y = np.random.default_rng(1).integers(0, 256, (24, 40), np.uint8)
dock = ocm.make_dock_step(24, 40, input_format="nv12", out_height=300,
                          dock=ocm.DockConfig(show_focuspeaking=True), device="cpu")
panel = dock(ocm.frame_from_numpy((y, y[:12]), "nv12", "cpu"), 1.0).panel
assert panel.shape == (300, 512, 4)
bad = sorted(m for m in sys.modules if m in ("jax", "obs_color_monitor_tpu")
             or m.startswith(("jax.", "jaxlib", "triton", "obs_color_monitor_tpu.")))
print("LOADED", bad)
from obs_color_monitor_tpu_torch import _kernels
print("KERNELS_LOADED", _kernels._lib is not None)  # the CPU route builds nothing
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True, env=env,
        cwd=REPO, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert "LOADED []" in res.stdout, res.stdout
    assert "KERNELS_LOADED False" in res.stdout, res.stdout
