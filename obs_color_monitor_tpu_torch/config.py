"""Scope configuration dataclasses — the reference's property model.

Copied whole from ``obs_color_monitor_tpu/config.py`` so that the torch
port imports nothing of the JAX package, plus :func:`from_reference`, which
carries a config object of the JAX package across to the port.

Each scope in the reference exposes an ``obs_data_t`` settings blob with
typed properties, defaults and ranges (``get_defaults``/``get_properties``
in each source file).  This module mirrors those names, defaults and ranges
exactly so a user of the reference finds the same knobs here.

Citations per field are given inline (reference file:line).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np

from .colorspace import Colorspace


class Components(enum.IntFlag):
    """Component-select bitmask (reference src/waveform.c:26-29).

    The low nibble-pairs mirror the reference's BGRA bit tests: bit 0x11
    selects B/U, 0x22 selects G/Y, 0x44 selects R/V
    (reference src/waveform.c:236-238, src/histogram.c:365-367).
    """

    RGB = 0x07
    Y = 0x20  # Luma
    UV = 0x50  # Chroma
    YUV = 0x70

    @property
    def n_components(self) -> int:
        """Popcount over the masked bits (reference src/waveform.c:175-182)."""
        return bin(int(self) & 0x77).count("1")

    @property
    def is_yuv(self) -> bool:
        return bool(int(self) & 0x70)

    def channel_select(self) -> tuple[bool, bool, bool]:
        """(c0, c1, c2) enables in Y/U/V or R/G/B order.

        Reference tests calc_b=0x11 (B or U), calc_g=0x22 (G or Y),
        calc_r=0x44 (R or V) (reference src/waveform.c:236-238).  In this
        framework's channel order (R,G,B) / (Y,U,V) that maps to:
        RGB mode: c0=R(0x44), c1=G(0x22), c2=B(0x11);
        YUV mode: c0=Y(0x22), c1=U(0x11), c2=V(0x44).
        """
        v = int(self)
        if v & 0x70:  # YUV mode
            return (bool(v & 0x22), bool(v & 0x11), bool(v & 0x44))
        return (bool(v & 0x44), bool(v & 0x22), bool(v & 0x11))


class DisplayMode(enum.IntEnum):
    """Waveform/histogram display (reference src/waveform.c:22-24)."""

    OVERLAY = 0
    STACK = 1
    PARADE = 2


class LevelMode(enum.IntEnum):
    """Histogram top-level normalization (reference src/histogram.c:31-33)."""

    AUTO = 0  # LEVEL_MODE_NONE: normalize to per-channel max
    PIXEL = 1  # fixed pixel count
    RATIO = 2  # percentage of total pixels


class VectorscopeColorType(enum.IntEnum):
    """Draw tint (reference src/vectorscope.c:36-39)."""

    WHITE = 0
    UV = 1


class GraticuleColor(enum.IntEnum):
    """Vectorscope graticule variants (reference src/vectorscope.c:184-190)."""

    NONE = 0
    AMBER = 1
    GREEN = 2
    AMBER_IQ = 1 | 256  # GRATICULES_IQ flag (reference src/vectorscope.c:23)
    GREEN_IQ = 2 | 256


class ShowKey(enum.IntEnum):
    """False-color key legend placement (reference src/zebra.c:20-28)."""

    NONE = 0
    LEFT = 1
    RIGHT = 2
    OUTSIDE = 3
    TOP = 4
    BOTTOM = 5
    BELOW = 6


def _clamp(v, lo, hi):
    return max(lo, min(hi, v))


# OBS combo properties accept only their listed values; snap arbitrary ints
# to the nearest member (ties break toward the smaller value).
_GRATICULE_LINES_COMBO = (0, 1, 2, 4, 5, 10)


def _snap_combo(v: int, allowed: tuple[int, ...]) -> int:
    g = int(v)
    return min(allowed, key=lambda a: (abs(a - g), a))


_FIELD_NAMES: dict[type, tuple[str, ...]] = {}

# monotonically increasing config generation (see _TrackedConfig)
_GEN = 0


class _TrackedConfig:
    """Base for config dataclasses: every FIELD assignment bumps a global
    generation counter into ``_gen``, giving the dock's per-frame cache
    revalidation an O(1) value-identity check — ``config_key`` memoizes
    its derived tuple per generation instead of re-walking every dataclass
    field each streamed frame (that derivation was ~a third of the
    stream route's host residual on this 1-core host, doc/performance.md).

    Caveat (documented contract): only FIELD ASSIGNMENT is tracked.
    Mutating a mutable field value in place (e.g. writing into a
    false-color LUT array) must be followed by reassigning the field
    (``cfg.lut = lut``, or ``scope.update(lut=lut)``) to invalidate.
    """

    def __setattr__(self, name, value):
        object.__setattr__(self, name, value)
        if not name.startswith("_"):
            global _GEN
            _GEN += 1
            object.__setattr__(self, "_gen", _GEN)


def config_key(cfg, skip: tuple[str, ...] = ()) -> tuple:
    """Hashable value-identity of a config: (class name, field values).

    Equivalent to ``repr(cfg)`` as a cache key (two configs with equal
    fields collide, a mutated field changes the key) but ~10x cheaper —
    the dock's fused/stream render caches revalidate every scope's key
    every frame, and string formatting dominated that host path
    (benchmarks/soak_stream.py).  Memoized per config GENERATION (see
    _TrackedConfig), so the steady-state revalidation is two dict probes.
    ``skip`` drops unhashable fields the caller fingerprints separately
    (e.g. a false-color LUT array).
    """
    d = cfg.__dict__
    gen = d.get("_gen")
    cache = None
    if gen is not None:  # untracked configs always re-derive
        cache = d.get("_ck_cache")
        if cache is not None and cache[0] == gen:
            hit = cache[1].get(skip)
            if hit is not None:
                return hit
        else:
            cache = (gen, {})
            object.__setattr__(cfg, "_ck_cache", cache)
    cls = type(cfg)
    names = _FIELD_NAMES.get(cls)
    if names is None:
        names = tuple(f.name for f in dataclasses.fields(cfg))
        _FIELD_NAMES[cls] = names
    key = (cls.__name__,) + tuple(d[n] for n in names if n not in skip)
    if cache is not None:
        cache[1][skip] = key
    return key


@dataclasses.dataclass
class CaptureConfig(_TrackedConfig):
    """Shared capture settings (the reference's ``cm`` properties,
    reference src/common.c:114-128)."""

    # Pre-downscale divisor 1..128, default 2 (reference src/common.c:88-90,
    # and per-scope get_defaults e.g. src/vectorscope.c:157).
    target_scale: int = 2
    # Pass the captured frame through unmodified (reference src/common.c:94).
    bypass: bool = False
    # AUTO resolves via calc_colorspace (reference src/util.c:25-41).
    colorspace: Colorspace = Colorspace.AUTO

    def __post_init__(self):
        self.target_scale = _clamp(int(self.target_scale), 1, 128)
        self.colorspace = Colorspace(self.colorspace)


@dataclasses.dataclass
class VectorscopeConfig(CaptureConfig):
    """Reference defaults: src/vectorscope.c:155-167."""

    intensity: int = 25  # 1..255 (reference src/vectorscope.c:178)
    color_type: VectorscopeColorType = VectorscopeColorType.UV
    graticule: GraticuleColor = GraticuleColor.AMBER_IQ
    graticule_skintone_color: int = 0x0054FF  # BGR (reference src/vectorscope.c:26)
    zoom: float = 1.0  # mouse-wheel zoom (reference src/vectorscope.c:473-482)

    def __post_init__(self):
        super().__post_init__()
        self.intensity = _clamp(int(self.intensity), 1, 255)
        self.color_type = VectorscopeColorType(self.color_type)
        self.zoom = max(1.0, float(self.zoom))


@dataclasses.dataclass
class WaveformConfig(CaptureConfig):
    """Reference defaults: src/waveform.c:110-116."""

    display: DisplayMode = DisplayMode.OVERLAY
    components: Components = Components.RGB
    intensity: int = 51  # 1..255 (reference src/waveform.c:113)
    graticule_lines: int = 5  # 0/1/2/4/5/10 (reference src/waveform.c:160-168)

    def __post_init__(self):
        super().__post_init__()
        self.display = DisplayMode(self.display)
        self.components = Components(self.components)
        self.intensity = _clamp(int(self.intensity), 1, 255)
        # the reference offers a fixed list {0,1,2,4,5,10} (an OBS combo,
        # src/waveform.c:160-168)
        self.graticule_lines = _snap_combo(self.graticule_lines, _GRATICULE_LINES_COMBO)


@dataclasses.dataclass
class HistogramConfig(CaptureConfig):
    """Reference defaults: src/histogram.c:163-171."""

    display: DisplayMode = DisplayMode.OVERLAY
    components: Components = Components.RGB
    level_height: int = 200  # 50..2048 (reference src/histogram.c:252)
    logscale: bool = False
    level_mode: LevelMode = LevelMode.AUTO
    level_fixed_value: int = 1000  # 50..65535 px (reference src/histogram.c:263)
    level_ratio_value: float = 10.0  # 1..100 % (reference src/histogram.c:265)
    graticule_vertical_lines: int = 5  # combo {0,1,2,4,5,10} (src/histogram.c:274-281)
    # The reference keeps TWO horizontal-step settings, one per level mode
    # (px combo for PIXEL, % combo for RATIO — src/histogram.c:283-290),
    # and applies whichever matches the active mode (src/histogram.c:137-151).
    # Both combos offer "None" = -1.
    graticule_horizontal_step_fixed: float = -1.0  # px
    graticule_horizontal_step_ratio: float = -1.0  # %

    def __post_init__(self):
        super().__post_init__()
        self.display = DisplayMode(self.display)
        self.components = Components(self.components)
        self.level_height = _clamp(int(self.level_height), 50, 2048)
        self.level_mode = LevelMode(self.level_mode)
        # reference property ranges (src/histogram.c:263-265)
        self.level_fixed_value = _clamp(int(self.level_fixed_value), 50, 65535)
        self.level_ratio_value = _clamp(float(self.level_ratio_value), 1.0, 100.0)
        # vertical-lines combo list (src/histogram.c:274-281, same set as the
        # waveform's)
        self.graticule_vertical_lines = _snap_combo(
            self.graticule_vertical_lines, _GRATICULE_LINES_COMBO
        )

    @property
    def graticule_horizontal_step(self) -> float:
        """Effective horizontal step: the setting matching the level mode
        (reference src/histogram.c:137-151; AUTO/log never load one, and
        create_graticule_vbuf's y_max=0 then draws no horizontal lines)."""
        if self.level_mode == LevelMode.PIXEL:
            return float(self.graticule_horizontal_step_fixed)
        if self.level_mode == LevelMode.RATIO:
            return float(self.graticule_horizontal_step_ratio)
        return -1.0

    @graticule_horizontal_step.setter
    def graticule_horizontal_step(self, v: float) -> None:
        """Legacy alias (pre-r3-final this was a single field applied in every
        level mode): writes BOTH mode-paired settings so old call sites and
        saved docks keep their horizontal graticule in whichever mode runs."""
        self.graticule_horizontal_step_fixed = float(v)
        self.graticule_horizontal_step_ratio = float(v)

    @property
    def level_fixed(self) -> int:
        """Effective fixed level; 0 unless PIXEL mode
        (reference src/histogram.c:131-146)."""
        return int(self.level_fixed_value) if self.level_mode == LevelMode.PIXEL else 0

    @property
    def level_ratio_permille(self) -> int:
        """Ratio stored as percent*10 (reference src/histogram.c:146-148)."""
        if self.level_mode != LevelMode.RATIO:
            return 0
        return int(self.level_ratio_value * 10.0 + 0.5)


@dataclasses.dataclass
class ZebraConfig(CaptureConfig):
    """Reference defaults: src/zebra.c:230-234."""

    zebra_th_low: int = 75  # percent, 50..100 (reference src/zebra.c:241-244)
    zebra_th_high: int = 100

    def __post_init__(self):
        super().__post_init__()
        self.zebra_th_low = _clamp(int(self.zebra_th_low), 50, 100)
        self.zebra_th_high = _clamp(int(self.zebra_th_high), 50, 100)

    @property
    def th_low(self) -> float:
        """Threshold scaled by 1e-2 (reference src/zebra.c:208-209)."""
        return self.zebra_th_low * 1e-2

    @property
    def th_high(self) -> float:
        return self.zebra_th_high * 1e-2


@dataclasses.dataclass
class FalseColorConfig(CaptureConfig):
    """False color shares the zebra struct (reference src/zebra.c:109-134)."""

    use_lut: bool = False
    # 1-D LUT sampled at (y, 0.5) — RGBA u8 of shape (N, 4)
    # (reference data/falsecolor.effect:36-37).
    lut: Optional[np.ndarray] = None
    show_key: ShowKey = ShowKey.NONE

    def __post_init__(self):
        super().__post_init__()
        self.show_key = ShowKey(self.show_key)
        if self.lut is not None:
            lut = np.asarray(self.lut, dtype=np.uint8)
            if lut.ndim != 2 or lut.shape[1] != 4:
                raise ValueError("falsecolor LUT must have shape (N, 4) RGBA u8")
            self.lut = lut


@dataclasses.dataclass
class FocusPeakingConfig(CaptureConfig):
    """Reference defaults: src/focuspeaking.c:20-21,130-134."""

    peaking_color: int = 0xFFFF5400  # ABGR (reference src/focuspeaking.c:20)
    peaking_threshold: float = 0.05  # 0.001..0.1
    actual_size: bool = False

    def __post_init__(self):
        super().__post_init__()
        self.peaking_threshold = _clamp(float(self.peaking_threshold), 0.001, 0.1)

    @property
    def peaking_rgba(self) -> tuple[float, float, float, float]:
        """Peaking color as normalized RGBA.

        The reference stores ABGR and swaps R/B before upload
        (reference src/focuspeaking.c:196-201).
        """
        c = int(self.peaking_color)
        a = (c >> 24) & 0xFF
        b = (c >> 16) & 0xFF
        g = (c >> 8) & 0xFF
        r = c & 0xFF
        return (r / 255.0, g / 255.0, b / 255.0, a / 255.0)


@dataclasses.dataclass
class ROIConfig(CaptureConfig):
    """Shared-capture hub settings (reference src/roi.c:93-99)."""

    interleave: int = 1  # 0..1: process every (n+1)-th frame
    # ROI rectangle in scaled coordinates; None = full frame
    # (reference src/roi.c:478-499 clamps into [0, w/h]).
    x0: int = -1
    y0: int = -1
    x1: int = -1
    y1: int = -1

    def __post_init__(self):
        super().__post_init__()
        self.interleave = _clamp(int(self.interleave), 0, 1)

    def resolve_rect(self, width: int, height: int) -> tuple[int, int, int, int]:
        """Clamp the ROI into the frame (reference src/roi.c:478-499)."""
        x0 = 0 if self.x0 < 0 else self.x0
        y0 = 0 if self.y0 < 0 else self.y0
        x1 = width if (self.x1 < 0 or self.x1 > width) else self.x1
        y1 = height if (self.y1 < 0 or self.y1 > height) else self.y1
        return x0, y0, x1, y1


@dataclasses.dataclass
class DockConfig(_TrackedConfig):
    """Composite view: which scopes are shown, stacked vertically
    (reference src/scope-widget.cpp:99-175).

    Defaults mirror ScopeWidget::default_properties (reference
    src/scope-widget.cpp:496-506): every source's "-shown" defaults true
    EXCEPT focus peaking, which the loop explicitly skips — a fresh dock
    shows the ROI preview and five scopes, with focus peaking opt-in.
    """

    show_roi: bool = True
    show_vectorscope: bool = True
    show_waveform: bool = True
    show_histogram: bool = True
    show_zebra: bool = True
    show_falsecolor: bool = True
    show_focuspeaking: bool = False
    width: int = 512
    height: int = 1536


def from_reference(cfg):
    """The port's config equal to ``cfg``, a config object of the JAX
    package (or of this module).

    Duck-typed: it reads ``cfg`` by the dataclass field names of the
    port's class of the same name and imports nothing of the JAX package.
    Enum values become this module's enum of the same name; a false-colour
    LUT array is copied, so the two configs share no mutable state.
    """
    cls = globals().get(type(cfg).__name__)
    if not (isinstance(cls, type) and dataclasses.is_dataclass(cls)
            and issubclass(cls, _TrackedConfig)):
        raise TypeError(f"no port config named {type(cfg).__name__!r}")
    kw = {}
    for f in dataclasses.fields(cls):
        if not hasattr(cfg, f.name):
            raise TypeError(f"{type(cfg).__name__} has no field {f.name!r}")
        v = getattr(cfg, f.name)
        if isinstance(v, enum.Enum):
            v = globals()[type(v).__name__](int(v))
        elif isinstance(v, np.ndarray):
            v = np.array(v, copy=True)
        kw[f.name] = v
    return cls(**kw)
