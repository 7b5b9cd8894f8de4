"""Source registry — the reference's plugin entry table.

Counterpart of ``obs_color_monitor_tpu/registry.py``; every created source
runs on ``device`` (default ``"cuda"``, as the port's other entry points).

``obs_module_load`` registers 11 source/filter infos (reference
src/plugin-main.c:58-108): vectorscope v1+v2, waveform, histogram, zebra
source+filter, false color source+filter, focus peaking source+filter, and
the ROI hub.  This registry exposes the same inventory by id, honoring the
GlobalConfig ShowSource/ShowFilter gates (reference src/plugin-main.c:67-79).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from . import config as cfg
from .config import VectorscopeColorType
from .models import (
    CaptureHub,
    FalseColor,
    FocusPeaking,
    Histogram,
    Vectorscope,
    Waveform,
    Zebra,
)
from .utils.persistence import GlobalConfig


@dataclasses.dataclass(frozen=True)
class SourceInfo:
    """One registered source (the reference's obs_source_info vtable)."""

    id: str
    name: str
    kind: str  # "source" | "filter"
    version: int
    factory: Callable
    config_cls: type
    obsolete: bool = False


def _vectorscope_v1(settings=None, device="cuda"):
    """v1 defaults: white draw color (reference vss_get_defaults_v1,
    src/vectorscope.c:155-161 — no color_type default, i.e. white)."""
    c = settings or cfg.VectorscopeConfig(color_type=VectorscopeColorType.WHITE)
    return Vectorscope(c, device)


REGISTRY: dict[str, SourceInfo] = {
    s.id: s
    for s in [
        SourceInfo(
            "vectorscope_source", "Vectorscope", "source", 1, _vectorscope_v1,
            cfg.VectorscopeConfig, obsolete=True,
        ),
        SourceInfo(
            "vectorscope_source.v2", "Vectorscope", "source", 2, Vectorscope,
            cfg.VectorscopeConfig,
        ),
        SourceInfo("waveform_source", "Waveform", "source", 1, Waveform, cfg.WaveformConfig),
        SourceInfo("histogram_source", "Histogram", "source", 1, Histogram, cfg.HistogramConfig),
        SourceInfo("zebra_source", "Zebra", "source", 1, Zebra, cfg.ZebraConfig),
        SourceInfo("zebra_filter", "Zebra", "filter", 1, Zebra, cfg.ZebraConfig),
        SourceInfo(
            "falsecolor_source", "False Color", "source", 1, FalseColor, cfg.FalseColorConfig
        ),
        SourceInfo(
            "falsecolor_filter", "False Color", "filter", 1, FalseColor, cfg.FalseColorConfig
        ),
        SourceInfo(
            "focuspeaking_source", "Focus Peaking", "source", 1, FocusPeaking,
            cfg.FocusPeakingConfig,
        ),
        SourceInfo(
            "focuspeaking_filter", "Focus Peaking", "filter", 1, FocusPeaking,
            cfg.FocusPeakingConfig,
        ),
        SourceInfo("colormonitor_roi", "ROI", "source", 1, CaptureHub, cfg.ROIConfig),
    ]
}


def create_source(source_id: str, settings=None, global_config: Optional[GlobalConfig] = None,
                  *, device="cuda"):
    """Instantiate a registered source by id (reference obs_source_create),
    on ``device``.

    GlobalConfig gates hide source/filter types like the reference's
    global.ini (src/plugin-main.c:67-79).
    """
    info = REGISTRY.get(source_id)
    if info is None:
        raise KeyError(f"unknown source id {source_id!r}")
    g = global_config or GlobalConfig()
    if info.kind == "source" and not g.show_sources:
        raise PermissionError(f"sources disabled by global config: {source_id}")
    if info.kind == "filter" and not g.show_filters:
        raise PermissionError(f"filters disabled by global config: {source_id}")
    if settings is not None:
        return info.factory(settings, device=device)
    return info.factory(device=device)


def enum_sources(kind: Optional[str] = None, include_obsolete: bool = False):
    """List registered ids (reference's source enumeration,
    src/util-cpp.cc:34-64 analog)."""
    return [
        s.id
        for s in REGISTRY.values()
        if (kind is None or s.kind == kind) and (include_obsolete or not s.obsolete)
    ]
