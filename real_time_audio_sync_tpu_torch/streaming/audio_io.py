"""Duplex audio runtime: generator-driven output alongside polled input.

The reference ``ims.audio.Audio`` is a *duplex* PyAudio wrapper polled once
per UI frame (ims/audio.py:64-103): it drains available input frames into
``input_func``, then asks a ``generator`` for exactly the number of frames
the output device can accept and writes them, forwarding the block to an
optional ``listen_func``; a falsy continue flag detaches the generator.
Round 1 rebuilt only the input half — this module completes the duplex
contract with the same polled-frame semantics against pluggable sinks
(an in-memory buffer for tests, a wav file, or a real PyAudio/sounddevice
device when one is importable).

Generator protocol (ims/audio.py:52-56): ``generate(num_frames,
num_channels) -> (data, continue_flag)`` where ``data`` is a numpy array of
``num_frames * num_channels`` interleaved samples.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np

from real_time_audio_sync_tpu_torch.config import FS
from real_time_audio_sync_tpu_torch.streaming.core import register_terminate_func
from real_time_audio_sync_tpu_torch.utils.wavio import load_wav


# ---------------------------------------------------------------------------
# Output sinks
# ---------------------------------------------------------------------------


class BufferSink:
    """In-memory sink with a bounded per-poll write window — models the
    device ring buffer that makes ``get_write_available`` vary per frame
    (ims/audio.py:79)."""

    def __init__(self, frames_per_poll: int = 512, num_channels: int = 1):
        self.frames_per_poll = frames_per_poll
        self.num_channels = num_channels
        self.chunks = []

    def get_write_available(self) -> int:
        return self.frames_per_poll

    def write(self, data: np.ndarray) -> None:
        self.chunks.append(np.asarray(data, np.float32))

    def samples(self) -> np.ndarray:
        return np.concatenate(self.chunks) if self.chunks else np.empty(0, np.float32)

    def close(self) -> None:
        pass


class WavFileSink(BufferSink):
    """Accumulates generated audio and writes a wav on close — the
    no-speaker stand-in for the reference's output device."""

    def __init__(self, path: str, frames_per_poll: int = 512, num_channels: int = 1):
        super().__init__(frames_per_poll, num_channels)
        self.path = path

    def close(self) -> None:
        from real_time_audio_sync_tpu_torch.streaming.writer import write_wave_file

        write_wave_file(self.samples(), self.num_channels, self.path)


class DeviceSink:
    """Real output device via pyaudio (or sounddevice), when importable."""

    def __init__(self, num_channels: int = 1, buffer_size: int = 512, sample_rate: int = FS):
        try:
            import pyaudio
        except ImportError as e:  # pragma: no cover - no audio stack in CI
            raise RuntimeError(
                "no audio output backend available (pyaudio not importable); "
                "use BufferSink/WavFileSink instead"
            ) from e
        self._pa = pyaudio.PyAudio()
        self._stream = self._pa.open(
            format=pyaudio.paFloat32,
            channels=num_channels,
            frames_per_buffer=buffer_size,
            rate=sample_rate,
            output=True,
        )

    def get_write_available(self) -> int:  # pragma: no cover
        return self._stream.get_write_available()

    def write(self, data: np.ndarray) -> None:  # pragma: no cover
        self._stream.write(np.asarray(data, np.float32).tobytes())

    def close(self) -> None:  # pragma: no cover
        self._stream.stop_stream()
        self._stream.close()
        self._pa.terminate()


# ---------------------------------------------------------------------------
# Generators (the reference's generator protocol, ims/audio.py:52-56)
# ---------------------------------------------------------------------------


class WavPlayback:
    """Plays a wav file once (reference-recording playback / monitoring)."""

    def __init__(self, path: Optional[str] = None, samples: Optional[np.ndarray] = None):
        if samples is None:
            samples, fs = load_wav(path)
            assert fs == FS
        self.samples = np.asarray(samples, np.float32)
        self.pos = 0

    def generate(self, num_frames: int, num_channels: int):
        out = np.zeros(num_frames * num_channels, np.float32)
        take = min(num_frames, len(self.samples) - self.pos)
        block = self.samples[self.pos : self.pos + take]
        for ch in range(num_channels):
            out[ch : take * num_channels : num_channels] = block
        self.pos += take
        return out, self.pos < len(self.samples)


class ClickTrack:
    """Short cosine-burst clicks at the ground-truth beat times — an audible
    score-position monitor built from the corpus CSVs (C16)."""

    def __init__(self, beat_times_sec, freq: float = 880.0, click_sec: float = 0.03, gain: float = 0.5):
        self.beats = np.asarray(sorted(beat_times_sec), np.float64)
        n = int(click_sec * FS)
        t = np.arange(n) / FS
        self.click = (gain * np.sin(2 * np.pi * freq * t) * np.hanning(n)).astype(np.float32)
        self.pos = 0  # absolute sample clock

    def generate(self, num_frames: int, num_channels: int):
        mono = np.zeros(num_frames, np.float32)
        start_t = self.pos / FS
        end_t = (self.pos + num_frames) / FS
        lo = np.searchsorted(self.beats, start_t - len(self.click) / FS)
        hi = np.searchsorted(self.beats, end_t)
        for b in self.beats[lo:hi]:
            k = int(round(b * FS)) - self.pos
            s, e = max(0, k), min(num_frames, k + len(self.click))
            if e > s:
                mono[s:e] += self.click[s - k : e - k]
        self.pos += num_frames
        out = np.repeat(mono, num_channels) if num_channels > 1 else mono
        more = self.pos / FS < (self.beats[-1] + 1.0) if len(self.beats) else False
        return out, more


# ---------------------------------------------------------------------------
# Duplex pump
# ---------------------------------------------------------------------------


class DuplexAudio:
    """Polled duplex audio — the full ``ims.audio.Audio`` contract
    (ims/audio.py:18-103): per :meth:`on_update`, drain available input into
    ``input_func``, then pull exactly ``get_write_available()`` frames from
    the generator, write them to the sink and forward to ``listen_func``.

    ``input_source`` is any iterable of sample buffers (streaming.sources);
    ``sink`` defaults to an in-memory :class:`BufferSink`."""

    def __init__(
        self,
        num_channels: int = 1,
        listen_func: Optional[Callable] = None,
        input_func: Optional[Callable] = None,
        input_source=None,
        sink=None,
    ):
        assert num_channels in (1, 2)  # ims/audio.py:26
        self.num_channels = num_channels
        self.listen_func = listen_func
        self.input_func = input_func
        self._input_iter = iter(input_source) if input_source is not None else None
        self.sink = sink if sink is not None else BufferSink(num_channels=num_channels)
        self.generator = None
        self.cpu_time = 0.0
        register_terminate_func(self.close)

    def set_generator(self, gen) -> None:
        """ims/audio.py:55-56."""
        self.generator = gen

    def get_cpu_load(self) -> float:
        """EMA of per-update pump time, in ms (ims/audio.py:60-61)."""
        return 1000.0 * self.cpu_time

    def on_update(self) -> None:
        """One polled frame (ims/audio.py:64-103): input first, then output."""
        t_start = time.perf_counter()

        if self.input_func and self._input_iter is not None:
            try:
                buf = next(self._input_iter)
                self.input_func(np.asarray(buf, np.float32), self.num_channels)
            except StopIteration:
                self._input_iter = None

        num_frames = self.sink.get_write_available()
        if self.generator and num_frames:
            data, continue_flag = self.generator.generate(num_frames, self.num_channels)
            assert len(data) == num_frames * self.num_channels, (
                f"asked for ({num_frames} * {self.num_channels}) frames but got {len(data)}"
            )  # ims/audio.py:83-84
            data = np.asarray(data)
            if data.dtype != np.float32:
                data = data.astype(np.float32)
            self.sink.write(data)
            if self.listen_func:
                self.listen_func(data, self.num_channels)
            if not continue_flag:
                self.generator = None  # ims/audio.py:97-98

        a = 0.9  # ims/audio.py:101-103
        self.cpu_time = a * self.cpu_time + (1 - a) * (time.perf_counter() - t_start)

    def close(self) -> None:
        self.sink.close()
