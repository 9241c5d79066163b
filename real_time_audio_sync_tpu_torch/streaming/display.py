"""Terminal display widgets — the gfxutil/Meter/Graph roles (SURVEY.md §2
C10, livenote_live.py:22-81) without Kivy/OpenGL.

``MeterDisplay`` renders a level bar, ``GraphDisplay`` a scrolling history
strip; both map a value range to a fixed-width character gauge.  ``KFAnim``
and ``AnimGroup`` reproduce the keyframe-interpolation utilities
(ims/gfxutil.py:66-106) used for cursor animation.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

_BLOCKS = " ▁▂▃▄▅▆▇█"


class MeterDisplay:
    """Level meter over a value range (MeterDisplay, livenote_live.py:22-49)."""

    def __init__(self, in_range: Tuple[float, float] = (-96.0, 0.0), width: int = 24):
        self.range = in_range
        self.width = width
        self.level = in_range[0]

    def set(self, level: float) -> None:
        self.level = float(level)

    def render(self) -> str:
        frac = float(np.interp(self.level, self.range, (0.0, 1.0)))
        filled = int(round(frac * self.width))
        return "[" + "█" * filled + " " * (self.width - filled) + "]"


class GraphDisplay:
    """Scrolling value history (GraphDisplay, livenote_live.py:52-81)."""

    def __init__(self, num_pts: int = 60, in_range: Tuple[float, float] = (-96.0, 0.0)):
        self.num_pts = num_pts
        self.range = in_range
        self.points: List[float] = []

    def add_point(self, y: float) -> None:
        self.points.append(float(y))
        if len(self.points) > self.num_pts:
            self.points = self.points[-self.num_pts :]

    def render(self) -> str:
        out = []
        for y in self.points:
            frac = float(np.interp(y, self.range, (0.0, 1.0)))
            out.append(_BLOCKS[int(round(frac * (len(_BLOCKS) - 1)))])
        return "".join(out).rjust(self.num_pts)


class KFAnim:
    """Piecewise-linear keyframe animation (ims/gfxutil.py:66-81): built from
    (time, v1[, v2...]) keyframes, evaluated with np.interp."""

    def __init__(self, *kf: Sequence[float]):
        frames = np.asarray(kf, dtype=float)
        self.time = frames[:, 0]
        self.values = frames[:, 1:]

    def eval(self, t: float):
        out = [float(np.interp(t, self.time, self.values[:, k])) for k in range(self.values.shape[1])]
        return out[0] if len(out) == 1 else out

    def is_active(self, t: float) -> bool:
        return t < self.time[-1]


class AnimGroup:
    """Container driving child objects' ``on_update(dt)``; children return
    False to be removed (ims/gfxutil.py:86-106)."""

    def __init__(self):
        self.objects: List = []

    def add(self, obj) -> None:
        self.objects.append(obj)

    def on_update(self, dt: float = 1 / 60) -> None:
        self.objects = [o for o in self.objects if o.on_update(dt) is not False]

    def size(self) -> int:
        return len(self.objects)


class CEllipse:
    """Center-positioned ellipse geometry (ims/gfxutil.py:34-58) without the
    Kivy canvas: holds ``pos``/``size`` with ``cpos``/``csize`` center-based
    accessors — resizing via ``csize`` keeps the center fixed."""

    def __init__(self, pos=(0.0, 0.0), size=(0.0, 0.0), cpos=None, csize=None, segments: int = 40):
        self.pos = tuple(pos)
        self.size = tuple(size)
        self.segments = segments
        if cpos is not None:
            self.cpos = cpos
        if csize is not None:
            self.csize = csize

    @property
    def cpos(self):
        return (self.pos[0] + self.size[0] / 2, self.pos[1] + self.size[1] / 2)

    @cpos.setter
    def cpos(self, p):
        self.pos = (p[0] - self.size[0] / 2, p[1] - self.size[1] / 2)

    @property
    def csize(self):
        return self.size

    @csize.setter
    def csize(self, s):
        c = self.cpos
        self.size = tuple(s)
        self.cpos = c


class Cursor3D:
    """Positional cursor over a display area (ims/gfxutil.py:112-141): a
    normalized 3D point maps x/y into the area rectangle and z into the
    cursor radius.  Headless — :meth:`render` draws a character-grid frame
    for the terminal apps instead of an OpenGL ellipse."""

    def __init__(self, area_size, area_pos, rgb=(1.0, 1.0, 1.0), size_range=(10, 50), border: bool = True):
        self.area_size = tuple(area_size)
        self.area_pos = tuple(area_pos)
        self.min_sz, self.max_sz = size_range
        self.border = border
        self.rgb = tuple(rgb)
        self.cursor = CEllipse(segments=40, csize=(30, 30))

    def set_pos(self, pos) -> None:
        """``pos`` is a 3D point with all values in [0, 1] (ims/gfxutil.py:132-136)."""
        pos = np.asarray(pos, dtype=float)
        radius = self.min_sz + pos[2] * (self.max_sz - self.min_sz)
        self.cursor.csize = (radius * 2, radius * 2)
        self.cursor.cpos = tuple(pos[0:2] * np.asarray(self.area_size) + np.asarray(self.area_pos))

    def set_color(self, rgb) -> None:
        self.rgb = tuple(rgb)

    def get_screen_xy(self):
        return self.cursor.cpos

    def render(self, cols: int = 40, rows: int = 12) -> str:
        """Character-grid view of the area with the cursor marked ``●``
        (larger z → heavier glyph)."""
        grid = [[" "] * cols for _ in range(rows)]
        if self.border:
            for c in range(cols):
                grid[0][c] = grid[-1][c] = "─"
            for r in range(rows):
                grid[r][0] = grid[r][-1] = "│"
        x, y = self.cursor.cpos
        fx = (x - self.area_pos[0]) / max(self.area_size[0], 1e-9)
        fy = (y - self.area_pos[1]) / max(self.area_size[1], 1e-9)
        c = int(np.clip(fx, 0, 1) * (cols - 1))
        r = int((1 - np.clip(fy, 0, 1)) * (rows - 1))
        frac = (self.cursor.csize[0] / 2 - self.min_sz) / max(self.max_sz - self.min_sz, 1e-9)
        grid[r][c] = "·•●"[int(np.clip(frac, 0, 1) * 2.999)]
        return "\n".join("".join(row) for row in grid)


class StatusLabel:
    """Top-of-screen status text (ims/gfxutil.py:25-29 ``topleft_label``):
    the live apps set ``.text`` every frame with the meter/beat/label readout
    (livenote_live.py:156-159).  Headless: :meth:`render` returns the text
    pinned to a fixed-width top line."""

    def __init__(self, width: int = 80):
        self.text = "text"
        self.width = width

    def render(self) -> str:
        lines = str(self.text).splitlines() or [""]
        return "\n".join(line[: self.width].ljust(self.width) for line in lines)


def topleft_label(width: int = 80) -> StatusLabel:
    """Reference factory name (ims/gfxutil.py:25)."""
    return StatusLabel(width)
