"""Typed configuration for the framework.

The reference passes plain dicts (e.g. ``{'search_band_width': 50,
'max_run_count': 3}`` at tests.py:140, ``{'c': 50, 'max_run_count': 3}`` at
livenote_live.py:94, WTW params at tests.py:174).  We keep the same parameter
names and semantics but expose them as dataclasses; every engine constructor
also accepts the reference's plain-dict spelling.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping


# Frontend constants (reference chroma.py:20-22). 4096/22050 ≈ 186 ms analysis
# window, 2048/22050 ≈ 92.9 ms hop → 10.77 feature frames per second.
FFT_LEN = 4096
HOP_SIZE = 2048
FS = 22050

# Seconds of audio represented by one feature frame (hard-coded as
# ``2048 / 22050.`` throughout the reference, e.g. tests.py:114).
FRAME_PERIOD_SEC = HOP_SIZE / float(FS)


@dataclasses.dataclass(frozen=True)
class OTWParams:
    """Online-time-warping parameters.

    ``c`` is the search band width and ``max_run_count`` the slope constraint
    (reference otw_eran.py:9-10).  LiveNote spells ``c`` as
    ``search_band_width`` (livenote.py:8); both spellings are accepted.
    """

    c: int = 50
    max_run_count: int = 3

    @staticmethod
    def from_any(params: "OTWParams | Mapping[str, Any]") -> "OTWParams":
        if isinstance(params, OTWParams):
            return params
        band = params.get("c", params.get("search_band_width"))
        if band is None:
            raise KeyError("params must provide 'c' or 'search_band_width'")
        return OTWParams(c=int(band), max_run_count=int(params["max_run_count"]))


@dataclasses.dataclass(frozen=True)
class WTWParams:
    """Windowed-time-warping parameters (reference wtw.py:27-30).

    ``dtw_win_size`` / ``dtw_hop_size`` are in *samples*; the window width in
    feature frames is ``dtw_win_size // hop_size`` (Python-2 integer division
    at wtw.py:96-107, preserved deliberately).
    """

    fft_len: int = 4096
    hop_size: int = 2048
    dtw_win_size: int = 4096 * 10
    dtw_hop_size: int = 2048 * 10

    def __post_init__(self):
        # dtw_hop_size < hop_size makes the committed live advance per
        # window 0 frames, so the reference's window loop (wtw.py:100)
        # never terminates; reject up front (graceful deviation — the
        # reference would hang)
        if self.dtw_hop_size < self.hop_size:
            raise ValueError(
                f"dtw_hop_size ({self.dtw_hop_size}) must be >= hop_size "
                f"({self.hop_size}): the window loop cannot advance otherwise"
            )
        if self.dtw_win_size < self.hop_size:
            raise ValueError("dtw_win_size must be at least one hop")

    @staticmethod
    def from_any(params: "WTWParams | Mapping[str, Any]") -> "WTWParams":
        if isinstance(params, WTWParams):
            return params
        return WTWParams(
            fft_len=int(params["fft_len"]),
            hop_size=int(params["hop_size"]),
            dtw_win_size=int(params["dtw_win_size"]),
            dtw_hop_size=int(params["dtw_hop_size"]),
        )

    @property
    def win_frames(self) -> int:
        return self.dtw_win_size // self.hop_size

    @property
    def hop_frames(self) -> int:
        return self.dtw_hop_size // self.hop_size

