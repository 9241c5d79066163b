"""Audio capture/writer — ims/writer.py parity.

``AudioWriter`` accumulates incoming buffers while active and writes a mono
wav (int16, scale 2¹⁵) or ``.npy`` with auto-numbered filenames
(ims/writer.py:16-69); ``combine_buffers`` concatenates buffer lists
(ims/writer.py:81-92, used by the live apps' hop framing).
"""

from __future__ import annotations

import os.path
from typing import List

import numpy as np

from real_time_audio_sync_tpu_torch.config import FS
from real_time_audio_sync_tpu_torch.utils.wavio import write_wav


def combine_buffers(buffers) -> np.ndarray:
    """Concatenate a list of sample buffers into one float32 array."""
    if not buffers:
        return np.empty(0, dtype=np.float32)
    return np.concatenate([np.asarray(b, np.float32) for b in buffers])


def write_wave_file(buf: np.ndarray, num_channels: int, name: str, sample_rate: int = FS) -> None:
    """int16 wav with 2**15 scaling (ims/writer.py:71-78)."""
    write_wav(name, np.asarray(buf), sr=sample_rate, num_channels=num_channels)


class AudioWriter:
    def __init__(self, filebase: str, output_wave: bool = True):
        self.active = False
        self.buffers: List[np.ndarray] = []
        self.filebase = filebase
        self.output_wave = output_wave

    def add_audio(self, data, num_channels: int = 1) -> None:
        if self.active:
            data = np.asarray(data)
            if num_channels == 2:  # single channel when stereo (ims/writer.py:27-28)
                data = data[0::2]
            self.buffers.append(data)

    def toggle(self) -> None:
        if self.active:
            self.stop()
        else:
            self.start()

    def start(self) -> None:
        if not self.active:
            self.active = True
            self.buffers = []

    def stop(self) -> str | None:
        """Returns the written filename (or None when nothing captured)."""
        if not self.active:
            return None
        self.active = False
        output = combine_buffers(self.buffers)
        if len(output) == 0:
            return None
        ext = "wav" if self.output_wave else "npy"
        filename = self._get_filename(ext)
        if self.output_wave:
            write_wave_file(output, 1, filename)
        else:
            np.save(filename, output)
        return filename

    def _get_filename(self, ext: str) -> str:
        suffix = 1
        while True:  # first non-existing auto-numbered name (ims/writer.py:62-69)
            filename = "%s%d.%s" % (self.filebase, suffix, ext)
            if not os.path.exists(filename):
                return filename
            suffix += 1
