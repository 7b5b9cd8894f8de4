"""The gate that runs the JAX package's own tests against the port
(``_torch_jax_suite``), checked: its exceptions table, its gate files, its
rewrite, the Pallas counterparts and the redirection of the port's
``device="cuda"`` defaults to the CPU."""

from __future__ import annotations

import ast
import importlib
import inspect
import re
import sys
from pathlib import Path

import pytest

import _torch_jax_suite as suite
import _torch_pallas_counterparts as cp

JAX, PORT = suite.JAX, suite.PORT
STEMS = suite.jax_test_files()
PALLAS = ("pallas_convert", "pallas_overlays", "pallas_pipeline", "pallas_stats")


def _gate_files() -> dict[str, list[str]]:
    """Each gate file -> the JAX files its ``expose`` call loads, read from
    its source."""
    out = {}
    for p in sorted(suite.TESTS.glob("test_torch_jax_suite_*.py")):
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "expose":
                out[p.name] = ast.literal_eval(node.args[1])
    return out


def _jax_tests(stem: str) -> set[str]:
    tree = ast.parse((suite.TESTS / f"{stem}.py").read_text())
    return {n.name for n in tree.body if isinstance(n, ast.FunctionDef)
            and n.name.startswith("test")}


def test_every_jax_file_is_loaded_by_exactly_one_gate_file():
    assert len(STEMS) == 23, STEMS
    gates = _gate_files()
    assert len(gates) >= 6, gates  # --dist loadfile spreads them over the workers
    loaded = [s for stems in gates.values() for s in stems]
    assert sorted(loaded) == STEMS


@pytest.mark.parametrize("key", sorted(suite.EXCEPTIONS))
def test_exception_names_a_jax_test_and_a_cause(key):
    stem, _, test = key.partition("::")
    assert stem in STEMS
    assert test.split("[", 1)[0] in _jax_tests(stem)
    assert suite.EXCEPTIONS[key] in suite.CAUSES


def test_exceptions_are_few():
    assert len(suite.EXCEPTIONS) <= 90


@pytest.mark.parametrize("stem", STEMS)
def test_rewrite_leaves_no_jax_package_name(stem):
    """After the rewrite the source names the port (and the counterparts)
    only, in imports, names and strings alike."""
    tree = suite._ToPort().visit(ast.parse((suite.TESTS / f"{stem}.py").read_text()))
    src = ast.unparse(ast.fix_missing_locations(tree))
    assert not re.search(rf"\b{JAX}\b", src)


def test_loading_aliases_no_jax_module():
    """Every JAX file loads; afterwards each ``obs_color_monitor_tpu``
    module in ``sys.modules`` is the JAX package's own, and no loaded test
    module holds one."""
    import obs_color_monitor_tpu as jpkg

    mods = {stem: suite.load(stem) for stem in STEMS}
    root = Path(jpkg.__file__).resolve().parent
    for name, mod in list(sys.modules.items()):
        if mod is not None and (name == JAX or name.startswith(JAX + ".")):
            assert mod.__name__ == name, name
            assert Path(mod.__file__).resolve().is_relative_to(root), name
    for stem, mod in mods.items():
        assert mod.__name__ == suite.module_name(stem)
        assert sys.modules[mod.__name__] is mod
        for value in vars(mod).values():
            owner = value.__name__ if inspect.ismodule(value) else getattr(value, "__module__", "")
            assert not re.match(rf"{JAX}(\.|$)", owner or ""), (stem, owner)


@pytest.mark.parametrize("name", PALLAS)
def test_counterparts_cover_the_pallas_module(name):
    """Each public function of the Pallas module has a counterpart with its
    parameters (``interpret=`` included), or a reason why not."""
    jmod = importlib.import_module(f"{JAX}.ops.{name}")
    public = {n for n, o in vars(jmod).items() if not n.startswith("_") and callable(o)
              and getattr(inspect.unwrap(o), "__module__", None) == jmod.__name__}
    mapped = {f for m, f in cp.TABLE if m == name}
    assert public == mapped | {f for m, f in cp.NO_COUNTERPART if m == name}
    sub = sys.modules[f"{cp.__name__}.{name}"]
    for fn in mapped:
        jparams = list(inspect.signature(inspect.unwrap(getattr(jmod, fn))).parameters)
        assert list(inspect.signature(getattr(sub, fn)).parameters) == jparams, fn
        port_mod, port_fn = cp.TABLE[name, fn]
        assert callable(getattr(importlib.import_module(f"{PORT}.{port_mod}"), port_fn))


def test_cuda_defaults_are_found_and_stay_cuda():
    """The walk finds the entry points' ``device="cuda"`` defaults, and
    outside a gate module they read "cuda" still (the CLI's too)."""
    import obs_color_monitor_tpu_torch.__main__ as cli

    found = suite.cuda_defaults()
    names = {fn.__qualname__ for fn, _, _ in found}
    assert {"make_full_step", "make_dock_step", "make_mesh", "nv12_device_planes",
            "create_source", "CaptureHub.__init__", "Dock.__init__", "Vectorscope.__init__",
            "Waveform.__init__", "Histogram.__init__", "Zebra.__init__",
            "FalseColor.__init__", "FocusPeaking.__init__"} <= names
    for fn, attr, value in found:
        now = getattr(fn, attr)
        assert now != value
        assert "cuda" in (now.values() if isinstance(now, dict) else now), fn
    assert cli._DEFAULT_DEVICE == "cuda"
