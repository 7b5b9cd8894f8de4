"""Settings persistence (the reference's checkpoint/resume story).

Counterpart of ``obs_color_monitor_tpu/utils/persistence.py`` (a copy on
the port's ``config``): a settings file written by either package loads
into the other.

The reference persists per-source settings in OBS scene-collection JSON and
dock state (which scopes are shown + each scope's settings) through
``obs_frontend_add_save_callback`` (reference src/scope-widget.cpp:517-577,
src/scope-dock.cpp:72-118).  Here every scope config serializes to/from a
JSON dict; Dock save data uses the same key scheme as the reference
("<id>-shown" / "<id>-prop").
"""

from __future__ import annotations

import dataclasses
import enum
import json
from pathlib import Path
from typing import Any

import numpy as np

from .. import config as config_mod


def config_to_dict(cfg) -> dict[str, Any]:
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if isinstance(v, enum.Enum):
            v = int(v)
        elif isinstance(v, np.ndarray):
            v = v.tolist()
        out[f.name] = v
    return out


def config_from_dict(cls, data: dict[str, Any]):
    names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {k: v for k, v in data.items() if k in names}
    if "lut" in kwargs and kwargs["lut"] is not None:
        kwargs["lut"] = np.asarray(kwargs["lut"], dtype=np.uint8)
    cfg = cls(**kwargs)
    # Legacy/renamed settings saved by older builds load through settable
    # property aliases (e.g. the histogram's pre-split
    # ``graticule_horizontal_step`` -> both mode-paired fields).
    legacy = False
    for k, v in data.items():
        if k in names:
            continue
        prop = getattr(cls, k, None)
        if isinstance(prop, property) and prop.fset is not None:
            setattr(cfg, k, v)
            legacy = True
    if legacy:
        cfg.__post_init__()  # re-apply reference clamping to aliased values
    return cfg


_SCOPE_CONFIGS = {
    "roi": config_mod.ROIConfig,
    "vectorscope": config_mod.VectorscopeConfig,
    "waveform": config_mod.WaveformConfig,
    "histogram": config_mod.HistogramConfig,
    "zebra": config_mod.ZebraConfig,
    "falsecolor": config_mod.FalseColorConfig,
    "focuspeaking": config_mod.FocusPeakingConfig,
}


def dock_save_data(dock) -> dict[str, Any]:
    """Dock state keyed like the reference ("<id>-shown"/"<id>-prop",
    reference src/scope-widget.cpp:517-545)."""
    data: dict[str, Any] = {
        "width": dock.config.width,
        "height": dock.config.height,
        "roi-prop": config_to_dict(dock.hub.config),
    }
    for name in _SCOPE_CONFIGS:
        if name == "roi":
            data["roi-shown"] = dock.shown("roi")
            continue
        data[f"{name}-shown"] = dock.shown(name)
        data[f"{name}-prop"] = config_to_dict(dock.scopes[name].config)
    return data


def dock_restore(dock, data: dict[str, Any]) -> None:
    """Apply saved dock state (reference src/scope-widget.cpp:546-577)."""
    dock.config.width = int(data.get("width", dock.config.width))
    dock.config.height = int(data.get("height", dock.config.height))
    if "roi-prop" in data:
        dock.hub.config = config_from_dict(config_mod.ROIConfig, data["roi-prop"])
    for name, cls in _SCOPE_CONFIGS.items():
        shown = data.get(f"{name}-shown")
        if shown is not None:
            setattr(dock.config, f"show_{name}", bool(shown))
        prop = data.get(f"{name}-prop")
        if prop is not None and name != "roi":
            dock.scopes[name].config = config_from_dict(cls, prop)


def save_dock(dock, path: str | Path) -> None:
    Path(path).write_text(json.dumps(dock_save_data(dock), indent=2))


def load_dock(dock, path: str | Path) -> None:
    dock_restore(dock, json.loads(Path(path).read_text()))


# ---------------------------------------------------------------------------
# Global config (the reference's global.ini [ColorMonitor] section,
# reference src/plugin-main.c:67-79, doc/global_config.md)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GlobalConfig:
    """Process-wide toggles mirroring ShowSource/ShowFilter."""

    show_sources: bool = True
    show_filters: bool = True

    @classmethod
    def load(cls, path: str | Path) -> "GlobalConfig":
        try:
            d = json.loads(Path(path).read_text())
        except FileNotFoundError:
            return cls()
        return cls(
            show_sources=bool(d.get("ShowSource", True)),
            show_filters=bool(d.get("ShowFilter", True)),
        )

    def save(self, path: str | Path) -> None:
        Path(path).write_text(
            json.dumps(
                {"ShowSource": self.show_sources, "ShowFilter": self.show_filters}
            )
        )


class DockManager:
    """Named-dock registry with bulk save/load (reference src/scope-dock.cpp:
    dock list + scene-collection persistence, scope-dock.cpp:72-118)."""

    def __init__(self):
        self.docks: dict[str, object] = {}

    def add(self, name: str, dock) -> None:
        if name in self.docks:
            raise KeyError(f"dock {name!r} already exists")
        self.docks[name] = dock

    def remove(self, name: str) -> None:
        self.docks.pop(name)

    def save_all(self) -> dict:
        """One blob for all docks (the reference stores a 'docks' array in
        the scene collection's save data)."""
        return {"docks": {n: dock_save_data(d) for n, d in self.docks.items()}}

    def load_all(self, data: dict, make_dock) -> None:
        """Recreate docks from save data; ``make_dock()`` builds a fresh Dock."""
        for name, blob in data.get("docks", {}).items():
            d = self.docks.get(name)
            if d is None:
                d = make_dock()
                self.docks[name] = d
            dock_restore(d, blob)
