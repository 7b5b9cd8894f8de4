"""The JAX package's own test suite, run against the port.

The JAX package's test files (``tests/test_*.py`` but the port's
``test_torch_*``) state what the package does.  This module reads each of
them, rewrites its source so that it tests the port, and executes it as a
module of its own; the gate files (``test_torch_jax_suite_<group>.py``)
expose its tests, each JAX case one test of its own.

- **The rewrite** (:func:`rewrite`): ``obs_color_monitor_tpu`` becomes
  ``obs_color_monitor_tpu_torch`` in imports, names and strings (attribute
  paths and ``monkeypatch`` targets); the four Pallas modules
  ``obs_color_monitor_tpu.ops.pallas_*`` become their counterparts in
  ``_torch_pallas_counterparts``.  Asserts are rewritten as pytest rewrites
  a test module's, for the same failure reports.
- **The module** (:func:`load`) is ``_torch_jax_suite.<stem>``, with the JAX
  file's ``__file__``.  Nothing is aliased in ``sys.modules``: the JAX
  package's own tests run in the same process, on the JAX package.
- **The exposed tests** (:func:`expose`) keep their parametrisation, their
  marks (a module's ``pytestmark`` too) and their fixtures (those of
  ``tests/conftest.py``, and the JAX file's own, copied into the gate
  module); each is named ``<stem>__<test>``.
- **The port on the CPU** (:func:`_port_on_cpu`): the port's entry points
  default to ``device="cuda"``; for the gate every such default (found by
  the signature gate's walk over the port's counterparts of the JAX
  package's public callables) and the CLI's ``--device`` default read
  "cpu", restored when the gate module ends.  The port's own defaults stay
  "cuda".
- **The exceptions** (:data:`EXCEPTIONS`): each JAX case that cannot apply
  to the port, with its cause from :data:`CAUSES`, runs as a strict xfail,
  so an entry whose case starts passing fails the gate.  Every other case
  must pass.
"""

from __future__ import annotations

import ast
import functools
import inspect
import re
import sys
import types
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent
JAX, PORT = "obs_color_monitor_tpu", "obs_color_monitor_tpu_torch"
COUNTERPARTS = "_torch_pallas_counterparts"
PREFIX = "_torch_jax_suite"

# the one cause an exception may give, by key
CAUSES = {
    "jax_internals": "JAX internals: the jitted programs' caches (_stream_fns, "
                     "_device_step_dynamic, _cache_size, _fused_render_fns, _composite_fns), "
                     "jax.Array type or fetch-count checks, the convert.jnp patch",
    "tpu_kernel": "TPU kernel internals: VMEM admission (pipeline_fits), Mosaic tiling, "
                  "interpret= behaviour",
    "jax_scripts": "the JAX package's own scripts run as subprocesses: examples/*.py, the "
                   "multihost worker",
    "mesh_model": "the mesh model: JAX's make_mesh(8) over 8 virtual devices in one process; "
                  "the port runs one process per device (tests/test_torch_parallel.py)",
}

# "<JAX file stem>::<test>" (every case of the test) or
# "<JAX file stem>::<test>[<case id>]" -> a key of CAUSES
EXCEPTIONS: dict[str, str] = {
    # the Dock's jitted stream program cache, _stream_fns
    **dict.fromkeys([f"test_stream_step::{t}" for t in (
        "test_stream_matches_legacy_frame_by_frame",
        "test_stream_with_roi_preview_and_rect",
        "test_stream_program_reused_not_retraced",
        "test_custom_consumer_disables_stream",
        "test_config_change_rebuilds_stream_program",
        "test_live_drag_serves_dynamic_step",
        "test_nv12_stream_one_program",
        "test_nv12_16bit_stream_matches_host_shift",
    )] + [f"test_models_pipeline::{t}" for t in (
        "test_driver_fed_dock_rides_stream_route",
        "test_driver_push_nv12_rides_stream_route",
        "test_driver_dock_mode_restart",
    )], "jax_internals"),
    # the Dock's dynamic-step flag, _device_step_dynamic, and the jitted
    # steps' _cache_size
    **dict.fromkeys([f"test_stream_step::{t}" for t in (
        "test_live_drag_custom_configs_and_midrag_config_change",
        "test_nv12_live_drag_dynamic_step",
        "test_dynamic_route_publishes_raw_and_marks_surface",
        "test_mid_drag_publishes_every_consumer",
    )] + [f"test_dynamic_roi::{t}" for t in (
        "test_dynamic_dock_step_matches_static",
        "test_dynamic_dock_key_legend",
        "test_render_device_drag_no_recompile",
        "test_interactive_roi_to_render_device",
    )] + ["test_dock_layout::test_roi_preview_drag_no_recompile"], "jax_internals"),
    # the Dock's fused-render and composite program caches
    **dict.fromkeys([f"test_fused_render::{t}" for t in (
        "test_fused_render_matches_legacy_streaming",
        "test_fused_program_is_reused",
        "test_fused_rebuilds_on_config_change",
        "test_fused_roi_drag_translation_reuses_program",
    )] + ["test_fuzz::test_composite_cache_bounded_under_live_resize"], "jax_internals"),
    # jax.Array types, counted fetches of a jax.Array, the convert.jnp patch
    "test_models_pipeline::test_driver_push_nv12_stages_on_producer_side": "jax_internals",
    "test_overlays_bitexact::test_falsecolor_key_streaming_stays_on_device": "jax_internals",
    "test_dock_layout::test_dock_render_single_fetch": "jax_internals",
    "test_stream_step::test_nv12_joint_upload": "jax_internals",
    # the TPU kernels' own limits and the TPU's route choice
    "test_pallas_convert::test_pallas_decode_rejects_bad_geometry": "tpu_kernel",  # W % 4
    "test_pallas_convert::test_dispatcher_prefers_pallas_on_tpu": "tpu_kernel",
    "test_pipeline_kernel::test_pipeline_rejects_other_scales": "tpu_kernel",  # 64-row bands
    "test_pipeline_kernel::test_pipeline_fits_split_admits_4k_scale1": "tpu_kernel",
    # subprocesses of the JAX package's scripts
    **dict.fromkeys([f"test_examples::{t}" for t in (
        "test_interactive_roi_drag",
        "test_multistream_serving",
        "test_p010_wire_ingest",
        "test_driver_pipeline",
        "test_driver_pipeline_nv12",
        "test_multihost_distributed_simulate",
    )] + ["test_multihost::test_two_process_distributed_bitexact"], "jax_scripts"),
    # make_mesh(8) in one process
    **dict.fromkeys([f"test_parallel::{t}" for t in (
        "test_batch_dp_bitexact",
        "test_spatial_sharding_bitexact",
        "test_spatial_sharding_requires_divisible",
        "test_batched_step_sharded",
        "test_spatial_pipeline_bitexact",
        "test_yuv_family_sharded",
    )], "mesh_model"),
}


def jax_test_files() -> list[str]:
    """The stems of the JAX package's test files."""
    return sorted(p.stem for p in TESTS.glob("test_*.py") if not p.stem.startswith("test_torch_"))


_NAME = re.compile(rf"\b{JAX}\b")
_PALLAS = re.compile(rf"\b{JAX}\.ops\.(pallas_\w+)")


def _rename(s: str) -> str:
    return _NAME.sub(PORT, _PALLAS.sub(rf"{COUNTERPARTS}.\1", s))


class _ToPort(ast.NodeTransformer):
    """The JAX package's names, as they appear in a test's source, made the
    port's (the Pallas modules their counterparts)."""

    def visit_Import(self, node):
        for a in node.names:
            a.name = _rename(a.name)
        return node

    def visit_ImportFrom(self, node):
        if node.module == f"{JAX}.ops":
            pallas = [a for a in node.names if a.name.startswith("pallas_")]
            rest = [a for a in node.names if not a.name.startswith("pallas_")]
            nodes = [ast.ImportFrom(module=COUNTERPARTS, names=pallas, level=0)] if pallas else []
            if rest:
                nodes.append(ast.ImportFrom(module=f"{PORT}.ops", names=rest, level=0))
            for n in nodes:
                ast.copy_location(n, node)
            return nodes
        if node.module:
            node.module = _rename(node.module)
        return node

    def visit_Name(self, node):
        node.id = _rename(node.id)
        return node

    def visit_Constant(self, node):
        if isinstance(node.value, str):
            node.value = _rename(node.value)
        return node


def rewrite(source: str, path: str = "<jax test>") -> ast.Module:
    """The JAX test file's source as a module tree that tests the port."""
    from _pytest.assertion.rewrite import rewrite_asserts

    tree = ast.fix_missing_locations(_ToPort().visit(ast.parse(source, path)))
    rewrite_asserts(tree, source.encode(), path)
    return tree


def module_name(stem: str) -> str:
    return f"{PREFIX}.{stem}"


def load(stem: str) -> types.ModuleType:
    """The JAX test file ``tests/<stem>.py``, rewritten for the port and
    executed as ``_torch_jax_suite.<stem>`` (once per process)."""
    name = module_name(stem)
    if name in sys.modules:
        return sys.modules[name]
    import _torch_pallas_counterparts  # noqa: F401  (the rewritten imports' target)

    path = TESTS / f"{stem}.py"
    mod = types.ModuleType(name)
    mod.__file__ = str(path)
    sys.modules[name] = mod  # dataclasses and pickling look their module up
    try:
        exec(compile(rewrite(path.read_text(), str(path)), str(path), "exec"), mod.__dict__)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


def _is_fixture(obj) -> bool:
    from _pytest.fixtures import FixtureFunctionDefinition

    return isinstance(obj, FixtureFunctionDefinition)


def _module_marks(mod) -> list:
    marks = getattr(mod, "pytestmark", [])
    return list(marks) if isinstance(marks, (list, tuple)) else [marks]


def expose(namespace: dict, stems: list[str]) -> None:
    """Put the tests of each JAX file in ``stems`` into a gate module's
    ``namespace``, as ``<stem>__<test>``, with the JAX file's fixtures, and
    the gate's own fixtures (the port on the CPU, the exceptions)."""
    import torch

    torch.set_num_threads(1)  # six workers share the host, as in the port's own tests
    fixtures: dict[str, str] = {}
    for stem in stems:
        mod = load(stem)
        marks = _module_marks(mod)
        for name, obj in vars(mod).items():
            if _is_fixture(obj):
                if name in fixtures:
                    raise ValueError(f"fixture {name!r} of {stem} is also {fixtures[name]}'s: "
                                     "load the two files in different gate files")
                fixtures[name] = stem
                namespace[name] = obj
            elif name.startswith("test") and inspect.isfunction(obj):
                for m in marks:
                    obj = m(obj)
                namespace[f"{stem}__{name}"] = obj
    namespace["_port_on_cpu"] = _port_on_cpu
    namespace["_jax_suite_exceptions"] = _jax_suite_exceptions
    namespace["JAX_SUITE_FILES"] = tuple(stems)


# --- the port on the CPU -----------------------------------------------------


def _device_defaults(fn):
    """``fn``'s ``__defaults__`` and ``__kwdefaults__`` with each "cuda" of
    a ``device`` parameter made "cpu": (attribute, new value) pairs."""
    fn = inspect.unwrap(fn)
    if not inspect.isfunction(fn):
        return []
    code = fn.__code__
    names = code.co_varnames[:code.co_argcount]
    out = []
    pos = fn.__defaults__ or ()
    if pos:
        new = tuple("cpu" if n == "device" and d == "cuda" else d
                    for n, d in zip(names[len(names) - len(pos):], pos))
        if new != pos:
            out.append((fn, "__defaults__", new))
    kw = fn.__kwdefaults__ or {}
    if kw.get("device") == "cuda":
        out.append((fn, "__kwdefaults__", {**kw, "device": "cpu"}))
    return out


@functools.lru_cache(maxsize=None)
def cuda_defaults() -> tuple:
    """Every ``device="cuda"`` default of the port that a JAX test can
    reach: the port's counterparts of the JAX package's public functions,
    methods and classes' ``__init__``/``__call__``, as the signature gate
    walks them.  (function, attribute, value with "cpu") triples."""
    from test_torch_signature_parity import ALL_CASES, LAZY_TARGETS, _module

    found: dict[tuple[int, str], tuple] = {}
    for rel, name in ALL_CASES:
        if not name:
            continue
        owner, _, member = name.partition(".")
        mod = _module(PORT, LAZY_TARGETS[owner] if rel == "" and owner in LAZY_TARGETS else rel)
        obj = getattr(mod, owner, None)
        if member:
            obj = inspect.getattr_static(obj, member, None) if obj is not None else None
            obj = getattr(obj, "__func__", obj)
        if callable(obj) and not inspect.isclass(obj):
            for fn, attr, value in _device_defaults(obj):
                found[(id(fn), attr)] = (fn, attr, value)
    return tuple(found.values())


@pytest.fixture(scope="module", autouse=True)
def _port_on_cpu():
    """The port's ``device="cuda"`` defaults, and the CLI's ``--device``
    default, read "cpu" while the gate module runs (module scope, so that
    a JAX file's module-scoped fixtures build on the CPU too); the port's
    ``ops.convert`` holds the XLA twins the JAX tests call
    (``_torch_pallas_counterparts.XLA_TWINS``).  A process group a JAX case
    started is destroyed at the end."""
    import torch.distributed as dist

    import obs_color_monitor_tpu_torch.__main__ as cli
    from _torch_pallas_counterparts import XLA_TWINS
    from obs_color_monitor_tpu_torch.ops import convert

    had_group = dist.is_initialized()
    mp = pytest.MonkeyPatch()
    for fn, attr, value in cuda_defaults():
        mp.setattr(fn, attr, value)
    mp.setattr(cli, "_DEFAULT_DEVICE", "cpu")
    for name, fn in XLA_TWINS.items():
        mp.setattr(convert, name, fn, raising=False)
    yield
    mp.undo()
    if dist.is_initialized() and not had_group:  # the next file in this worker starts clean
        dist.destroy_process_group()


# --- the exceptions ----------------------------------------------------------


def exception_for(stem: str, test_name: str) -> str | None:
    """The cause key for the JAX case ``<stem>::<test_name>`` (its id as
    pytest names it, with ``[case]``), or None."""
    base = test_name.split("[", 1)[0]
    return EXCEPTIONS.get(f"{stem}::{test_name}") or EXCEPTIONS.get(f"{stem}::{base}")


@pytest.fixture(autouse=True)
def _jax_suite_exceptions(request):
    """A listed case runs as a strict xfail.  A case of the JAX package's
    own scripts is not run (``run=False``): its subprocess runs the JAX
    package whatever the rewrite does, so it would pass without touching
    the port."""
    stem, _, test = request.node.name.partition("__")
    key = exception_for(stem, test)
    if key is not None:
        request.applymarker(pytest.mark.xfail(strict=True, reason=CAUSES[key],
                                              run=key != "jax_scripts"))
