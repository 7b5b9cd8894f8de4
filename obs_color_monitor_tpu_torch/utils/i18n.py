"""Minimal locale machinery (reference data/locale/*.ini, 5 languages).

Counterpart of ``obs_color_monitor_tpu/utils/i18n.py`` (a copy); the locale
tables are the port's own copies under ``data/locale/``.

The reference looks up UI strings through ``obs_module_text``.  Here
:func:`text` resolves keys against JSON locale tables; en-US ships built in,
additional languages drop into ``data/locale/<tag>.json``.
"""

from __future__ import annotations

import json
from pathlib import Path

_LOCALE_DIR = Path(__file__).resolve().parents[1] / "data" / "locale"

# Built-in en-US strings (full key set of the reference's
# data/locale/en-US.ini, 91 keys; data/locale/en-US.json is the same
# table on disk for tooling).
_EN_US = {
    "601": "601",
    "709": "709",
    "Amber": "Amber",
    "Amber, IQ": "Amber, IQ",
    "Auto": "Auto",
    "Basic.PropertiesWindow.AddEditableListEntry": "Add entry to '%1'",
    "Basic.PropertiesWindow.AutoSelectFormat": "%1 (autoselect: %2)",
    "Basic.PropertiesWindow.EditEditableListEntry": "Edit entry from '%1'",
    "Basic.PropertiesWindow.SelectColor": "Select color",
    "Basic.PropertiesWindow.SelectFont": "Select font",
    "Bypass": "Bypass",
    "Chroma": "Chroma",
    "Color space": "Color space",
    "Components": "Components",
    "Display": "Display",
    "False Color": "False Color",
    "FalseColor.Prop.LUT": "Use LUT",
    "FalseColor.Prop.LUTFile": "LUT file name",
    "FalseColor.Prop.LUTFile.Filter.All": "All files",
    "FalseColor.Prop.LUTFile.Filter.Image": "All image files",
    "FocusPeaking.Name": "Focus Peaking",
    "FocusPeaking.Prop.ActualSize": "Actual Size",
    "FocusPeaking.Prop.PeakingColor": "Color",
    "FocusPeaking.Prop.PeakingThreshold": "Threshold",
    "Graticule": "Graticule",
    "Graticule.Step.10": "Each 10%",
    "Graticule.Step.100": "0%, 100%",
    "Graticule.Step.20": "Each 20%",
    "Graticule.Step.25": "Each 25%",
    "Graticule.Step.50": "0%, 50%, 100%",
    "Green": "Green",
    "Green, IQ": "Green, IQ",
    "Height": "Height",
    "Hide": "Hide",
    "Histogram": "Histogram",
    "Histogram.Graticule.H": "Graticule (Horizontal)",
    "Histogram.Graticule.V": "Graticule (Vertical)",
    "Intensity": "Intensity",
    "Interleave": "Interleave",
    "Level mode": "Level mode",
    "Log scale": "Log scale",
    "Luma": "Luma",
    "MainView": "Main view",
    "New Scope Dock...": "New Scope Dock...",
    "None": "None",
    "OK": "OK",
    "Overlay": "Overlay",
    "Parade": "Parade",
    "Pixels": "Pixels",
    "Preview": "Preview",
    "Program": "Program",
    "Prop.ShowKey": "Show key",
    "Prop.ShowKey.Below": "Outside (Bottom)",
    "Prop.ShowKey.Bottom": "Bottom",
    "Prop.ShowKey.Left": "Left",
    "Prop.ShowKey.None": "None",
    "Prop.ShowKey.Outside": "Outside (Right)",
    "Prop.ShowKey.Right": "Right",
    "Prop.ShowKey.Top": "Top",
    "RGB": "RGB",
    "ROI": "ROI",
    "Ratio": "Ratio",
    "Scale": "Scale",
    "Show": "Show",
    "Skin tone color": "Skin tone color",
    "Source": "Source",
    "Stack": "Stack",
    "Threshold (high)": "Threshold (high)",
    "Threshold (lower)": "Threshold (lower)",
    "Top level": "Top level",
    "VS.Prop.ColorType": "Color Type",
    "VS.Prop.ColorType.UV": "Chroma",
    "VS.Prop.ColorType.White": "White",
    "Vectorscope": "Vectorscope",
    "Waveform": "Waveform",
    "YUV": "YUV",
    "Zebra": "Zebra",
    "dock.dialog.note": "Other sources can be selected from the property after creating the dock.",
    "dock.dialog.title": "Dock Title",
    "dock.menu.close": "Close (&X)",
    "dock.menu.projector": "Open Pro&jector",
    "dock.menu.properties": "Properties...",
    "dock.menu.show.falsecolor": "Show &False Color",
    "dock.menu.show.focuspeaking": "Show Focus &Peaking",
    "dock.menu.show.histogram": "Show &Histogram",
    "dock.menu.show.roi": "Show &ROI",
    "dock.menu.show.vectorscope": "Show &Vectorscope",
    "dock.menu.show.waveform": "Show &Waveform",
    "dock.menu.show.zebra": "Show &Zebra",
    "srclist.prefix.scene": "Scene: ",
    "srclist.prefix.source": "Source: ",
}

_current: dict[str, str] = dict(_EN_US)
_tag = "en-US"


def set_locale(tag: str) -> None:
    """Switch locale; unknown tags fall back to en-US keys per string."""
    global _current, _tag
    _current = dict(_EN_US)
    _tag = tag
    if tag != "en-US":
        path = _LOCALE_DIR / f"{tag}.json"
        if path.exists():
            _current.update(json.loads(path.read_text()))


def get_locale() -> str:
    return _tag


def text(key: str) -> str:
    """obs_module_text analog: missing keys return the key itself."""
    return _current.get(key, key)
