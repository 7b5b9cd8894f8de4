"""Every public signature of the port held to the JAX package's.

For every module of ``obs_color_monitor_tpu`` (the Pallas kernel modules
excepted) the port's module of the same name must hold:

- every public name the JAX module defines (found in its source, and at
  run time with jitted, ``lru_cache``d and ``functools.wraps``d callables
  unwrapped), and every name of its ``__all__`` in the port's ``__all__``;
- for each function, method, staticmethod and classmethod (``__init__``
  and ``__call__`` included): JAX's parameters first, with the same names,
  kinds and order, and the same defaults (enums by value, arrays by
  ``array_equal``, dataclass instances field by field); the port may only
  append parameters, each with a default (``device``, say);
- for each property and class attribute: one of the same name;
- for each NamedTuple and dataclass: JAX's fields first and in order, with
  the same defaults; the port may append dataclass fields (with a default),
  but a NamedTuple's length is part of its contract, so a field appended
  to one must be listed in ``EXCEPTIONS``;
- for each enum: every member, by value.

Each case is one (module, name).  ``EXCEPTIONS`` is the whole list of
intended differences, each with its reason, and every entry must still
match something.
"""

from __future__ import annotations

import ast
import dataclasses
import enum
import fnmatch
import importlib
import inspect
from pathlib import Path

import numpy as np
import pytest

import obs_color_monitor_tpu as jpkg

JAX, PORT = "obs_color_monitor_tpu", "obs_color_monitor_tpu_torch"

# case-id pattern (fnmatch on "module:qualname", "" being the package
# itself) -> why the port differs there
EXCEPTIONS = {
    "ops.pallas_*": "the TPU's Pallas kernels: each has a hand-written CUDA counterpart "
                    "(ops/csrc/, wrapped in ops/pipeline, scope_stats, fused_overlays and "
                    "decode; PERF.md §6), so the modules themselves have no port",
    "models.*:*.render_leaves": "JAX's traced-render plumbing (a leaf tuple traced into the "
                                "Dock's jitted stream program): graphs.CapturedStep takes "
                                "its place",
    "models.*:*.render_traced": "JAX's traced-render plumbing: graphs.CapturedStep takes its "
                                "place",
    "models.*:*.render_trace_key": "JAX's traced-render plumbing (the jitted program's cache "
                                   "key): graphs.CapturedStep takes its place",
    "pipeline.driver:NV12Frame.ready": "a field the port appends: the CUDA event recorded "
                                       "after the frame's upload on the producer's stream "
                                       "(None on the CPU), which the worker waits on",
    ":make_full_step": "JAX's top-level lazy wrapper takes (*args, **kwargs); compared with "
                       "its target, api.make_full_step",
    ":make_dock_step": "JAX's top-level lazy wrapper takes (*args, **kwargs); compared with "
                       "its target, dock_step.make_dock_step",
}
# the lazy wrappers' targets (module of the JAX package)
LAZY_TARGETS = {"make_full_step": "api", "make_dock_step": "dock_step"}


def _excepted(case_id: str) -> str | None:
    return next((p for p in EXCEPTIONS if fnmatch.fnmatchcase(case_id, p)), None)


def _jax_modules() -> list[str]:
    """The JAX package's Python modules, relative to the package ("" is
    the package itself)."""
    root = Path(jpkg.__file__).parent
    names = []
    for p in root.rglob("*.py"):
        parts = p.relative_to(root).with_suffix("").parts
        names.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return sorted(names)


def _module(pkg: str, rel: str):
    return importlib.import_module(f"{pkg}.{rel}" if rel else pkg)


def _top_level_names(mod) -> set[str]:
    """Public names the module's own source binds at top level (also under
    a top-level ``if``/``try``), and public callables or classes whose
    unwrapped ``__module__`` is this module."""
    names: set[str] = set()
    src = inspect.getsource(mod)

    def visit(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                names.add(node.name)
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name):
                            names.add(n.id)
            elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
                names.add(node.target.id)
            elif isinstance(node, ast.If):
                visit(node.body)
                visit(node.orelse)
            elif isinstance(node, ast.Try):
                visit(node.body)
                for h in node.handlers:
                    visit(h.body)
                visit(node.orelse)
                visit(node.finalbody)

    visit(ast.parse(src).body)
    for name, obj in vars(mod).items():
        if callable(obj) and getattr(inspect.unwrap(obj), "__module__", None) == mod.__name__:
            names.add(name)
    return {n for n in names if not n.startswith("_") and n != "annotations"}


def _is_namedtuple(cls) -> bool:
    return isinstance(cls, type) and issubclass(cls, tuple) and hasattr(cls, "_fields")


def _class_members(cls) -> list[str]:
    """Public attributes of a class (inherited ones too) plus the
    ``__init__`` and ``__call__`` that a class of the package defines."""
    names = sorted(n for n in dir(cls) if not n.startswith("_"))
    for dunder in ("__init__", "__call__"):
        owner = next((k for k in cls.__mro__ if dunder in vars(k)), object)
        if owner.__module__.startswith(JAX + ".") and not (
                dunder == "__init__" and dataclasses.is_dataclass(cls)):
            names.append(dunder)
    return names


def _all_cases() -> list[tuple[str, str]]:
    """Every (module, name) of the JAX package that the gate looks at."""
    cases = []
    for rel in _jax_modules():
        if _excepted(rel):
            cases.append((rel, ""))
            continue
        mod = _module(JAX, rel)
        for name in sorted(_top_level_names(mod)):
            cases.append((rel, name))
            obj = getattr(mod, name)
            if (inspect.isclass(obj) and obj.__module__ == mod.__name__
                    and not issubclass(obj, enum.Enum)):
                for member in _class_members(obj):
                    cases.append((rel, f"{name}.{member}"))
    return cases


def _case_id(rel, name):
    return f"{rel}:{name}" if name else rel


ALL_CASES = _all_cases()
# the lazy wrappers are held to their targets; every other exception is no case
CASES = [c for c in ALL_CASES
         if not _excepted(_case_id(*c)) or (c[0] == "" and c[1] in LAZY_TARGETS)]


# --- comparisons -------------------------------------------------------------


def _same(a, b) -> bool:
    """Equal defaults across the packages: enums by value, arrays by
    ``array_equal``, dataclass instances field by field (the port may
    append fields), containers element by element."""
    if a is inspect.Parameter.empty or b is inspect.Parameter.empty:
        return a is b
    if isinstance(a, enum.Enum):
        return (b.value if isinstance(b, enum.Enum) else b) == a.value
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        return dataclasses.is_dataclass(b) and all(
            _same(getattr(a, f.name), getattr(b, f.name, inspect.Parameter.empty))
            for f in dataclasses.fields(a))
    if isinstance(a, (tuple, list)) and not hasattr(a, "_fields"):
        return isinstance(b, (tuple, list)) and len(a) == len(b) and all(
            _same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same(a[k], b[k]) for k in a)
    if hasattr(a, "__array__") and not isinstance(a, (int, float, bool)):
        return hasattr(b, "__array__") and np.array_equal(np.asarray(a), np.asarray(b))
    if callable(a) and not isinstance(a, type):
        return getattr(a, "__name__", a) == getattr(b, "__name__", b)
    if isinstance(a, type):
        return isinstance(b, type) and a.__name__ == b.__name__
    return bool(a == b)


def _signature_faults(jfn, tfn) -> list[str]:
    """What keeps a call written for ``jfn`` from binding the same way to
    ``tfn``: JAX's parameters must come first, with the same names, kinds
    and defaults; each parameter the port appends needs a default.  A
    ``**kwargs`` is compared on its own: a keyword-only parameter that the
    port appends stands before it, as Python requires."""
    js = inspect.signature(inspect.unwrap(jfn))
    ts = inspect.signature(inspect.unwrap(tfn))
    var_kw = inspect.Parameter.VAR_KEYWORD
    jp = [p for p in js.parameters.values() if p.kind != var_kw]
    tp = [p for p in ts.parameters.values() if p.kind != var_kw]
    faults = []
    for i, p in enumerate(jp):
        if i >= len(tp):
            faults.append(f"missing parameter {p.name!r} (JAX position {i})")
            continue
        q = tp[i]
        if q.name != p.name:
            faults.append(f"position {i}: {q.name!r} where JAX has {p.name!r}")
        elif q.kind != p.kind:
            faults.append(f"{p.name!r}: {q.kind.description} where JAX has {p.kind.description}")
        elif not _same(p.default, q.default):
            faults.append(f"{p.name!r}: default {q.default!r} where JAX has {p.default!r}")
    for q in tp[len(jp):]:
        if q.default is inspect.Parameter.empty and q.kind != q.VAR_POSITIONAL:
            faults.append(f"appended parameter {q.name!r} has no default")
    j_kw = [p.name for p in js.parameters.values() if p.kind == var_kw]
    t_kw = [p.name for p in ts.parameters.values() if p.kind == var_kw]
    if j_kw and not t_kw:
        faults.append(f"no **{j_kw[0]}")
    return faults


def _field_faults(jcls, tcls, qual: str) -> list[str]:
    """``qual`` is the case id, ``module:Class``."""
    faults = []
    if _is_namedtuple(jcls):
        if not _is_namedtuple(tcls):
            return [f"{qual} is a NamedTuple in JAX, not in the port"]
        jf, tf = jcls._fields, tcls._fields
        if tf[:len(jf)] != jf:
            faults.append(f"{qual}: fields {tf} do not start with JAX's {jf}")
        for extra in tf[len(jf):]:
            if not _excepted(f"{qual}.{extra}"):
                faults.append(f"{qual}: field {extra!r} appended to a NamedTuple (its length "
                              "is part of its contract) without an exception")
        for k, v in jcls._field_defaults.items():
            if not _same(v, tcls._field_defaults.get(k, inspect.Parameter.empty)):
                faults.append(f"{qual}.{k}: default differs")
    if dataclasses.is_dataclass(jcls):
        if not dataclasses.is_dataclass(tcls):
            return [f"{qual} is a dataclass in JAX, not in the port"]
        jf = [f.name for f in dataclasses.fields(jcls)]
        tf = {f.name: f for f in dataclasses.fields(tcls)}
        if list(tf)[:len(jf)] != jf:
            faults.append(f"{qual}: fields {list(tf)} do not start with JAX's {jf}")

        def default(f):
            if f.default is not dataclasses.MISSING:
                return f.default
            if f.default_factory is not dataclasses.MISSING:
                return f.default_factory()
            return inspect.Parameter.empty

        for f in dataclasses.fields(jcls):
            if f.name in tf and not _same(default(f), default(tf[f.name])):
                faults.append(f"{qual}.{f.name}: default {default(tf[f.name])!r} where JAX "
                              f"has {default(f)!r}")
        for name in list(tf)[len(jf):]:
            if default(tf[name]) is inspect.Parameter.empty:
                faults.append(f"{qual}: appended field {name!r} has no default")
    if issubclass(jcls, enum.Enum):
        for m in jcls:
            if m.name not in tcls.__members__ or tcls[m.name].value != m.value:
                faults.append(f"{qual}.{m.name}: missing or of another value")
    return faults


def _member_faults(jcls, tcls, member: str) -> list[str]:
    jattr = inspect.getattr_static(jcls, member)
    try:
        tattr = inspect.getattr_static(tcls, member)
    except AttributeError:
        return [f"missing in the port's {tcls.__name__}"]
    if isinstance(jattr, property):
        return [] if isinstance(tattr, property) else ["a property in JAX, not in the port"]
    for kind in (staticmethod, classmethod):
        if isinstance(jattr, kind):
            if not isinstance(tattr, kind):
                return [f"a {kind.__name__} in JAX, not in the port"]
            return _signature_faults(jattr.__func__, tattr.__func__)
    if callable(jattr) and not isinstance(jattr, type):
        if not callable(tattr):
            return ["callable in JAX, not in the port"]
        return _signature_faults(jattr, tattr)
    return []


# module constants of these types are compared by value
_DATA = (int, float, str, bytes, tuple, list, dict, set, frozenset, enum.Enum)


def _case_faults(rel: str, name: str) -> list[str]:
    jmod, tmod = _module(JAX, rel), _module(PORT, rel)
    owner, _, member = name.partition(".")
    if rel == "" and owner in LAZY_TARGETS:
        jmod = _module(JAX, LAZY_TARGETS[owner])
    jobj = getattr(jmod, owner)
    if not hasattr(tmod, owner):
        return [f"{PORT}.{rel or ''}: {owner!r} missing"]
    tobj = getattr(tmod, owner)
    if member:
        return _member_faults(jobj, tobj, member)
    if inspect.isclass(jobj):
        if not inspect.isclass(tobj):
            return [f"{owner} is a class in JAX, not in the port"]
        return _field_faults(jobj, tobj, _case_id(rel, owner))
    if inspect.ismodule(jobj):
        return []
    if callable(jobj):
        if not callable(tobj):
            return [f"{owner} is callable in JAX, not in the port"]
        return _signature_faults(jobj, tobj)
    if isinstance(jobj, _DATA) or hasattr(jobj, "__array__") or dataclasses.is_dataclass(jobj):
        return [] if _same(jobj, tobj) else [f"{owner} = {tobj!r} where JAX has {jobj!r}"]
    if type(jobj).__name__ != type(tobj).__name__:  # a logger, say
        return [f"{owner} is a {type(tobj).__name__} where JAX has a {type(jobj).__name__}"]
    return []


@pytest.mark.parametrize("rel,name", CASES, ids=[_case_id(*c) for c in CASES])
def test_port_holds_jax_signature(rel, name):
    faults = _case_faults(rel, name)
    assert not faults, (_case_id(rel, name), faults)


MODULES = [m for m in _jax_modules() if not _excepted(m)]


@pytest.mark.parametrize("rel", MODULES, ids=[m or "<package>" for m in MODULES])
def test_port_all_holds_jax_all(rel):
    jall = getattr(_module(JAX, rel), "__all__", ())
    tall = getattr(_module(PORT, rel), "__all__", ())
    assert not set(jall) - set(tall), sorted(set(jall) - set(tall))


def test_every_exception_is_used():
    ids = [_case_id(*c) for c in ALL_CASES]
    ids += [f"pipeline.driver:NV12Frame.{f}" for f in
            importlib.import_module(PORT + ".pipeline.driver").NV12Frame._fields]
    unused = [p for p in EXCEPTIONS if not any(fnmatch.fnmatchcase(i, p) for i in ids)]
    assert not unused, unused
