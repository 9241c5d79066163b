"""Audio device configuration — ims/audio.py:134-184 parity.

An INI file (default ``~/audio_config.cfg``, same location and section as
the reference) holding output/input device indices, buffer size and sample
rate, with the reference's defaults (buffersize 512, samplerate 44100 —
ims/audio.py:162-166) and device-index validation against the enumerated
devices.  Device enumeration degrades gracefully when no audio backend is
installed (a GPU server has none; SimulatedMic needs no devices).  A copy
of the JAX package's module.
"""

from __future__ import annotations

import configparser
import os.path
from typing import Dict, List, Optional

CONFIG_FILE = os.path.expanduser("~/audio_config.cfg")

DEFAULTS = {
    "outputdevice": None,
    "inputdevice": None,
    "buffersize": 512,
    "samplerate": 44100,
}


def get_audio_devices() -> Dict[str, List[dict]]:
    """Available devices as ``{'input': [...], 'output': [...]}`` with a
    'Default' placeholder first (ims/audio.py:188-224); empty-but-valid when
    no audio backend exists."""
    out: List[dict] = [{"index": None, "name": "Default", "channels": 0, "latency": (0, 0)}]
    inp: List[dict] = [{"index": None, "name": "Default", "channels": 0, "latency": (0, 0)}]
    try:  # pragma: no cover - hardware-dependent
        import pyaudio

        audio = pyaudio.PyAudio()
        for i in range(audio.get_device_count()):
            dev = audio.get_device_info_by_index(i)
            info = {"index": dev["index"], "name": dev["name"]}
            if dev["maxOutputChannels"] > 0:
                out.append({**info, "channels": dev["maxOutputChannels"],
                            "latency": (dev["defaultLowOutputLatency"], dev["defaultHighOutputLatency"])})
            if dev["maxInputChannels"] > 0:
                inp.append({**info, "channels": dev["maxInputChannels"],
                            "latency": (dev["defaultLowInputLatency"], dev["defaultHighInputLatency"])})
        audio.terminate()
    except ImportError:
        pass
    return {"output": out, "input": inp}


def load_audio_config(config_file: str = CONFIG_FILE) -> Dict[str, Optional[int]]:
    """Read the ``[audio]`` section; fill defaults; validate device indices
    (ims/audio.py:138-175 semantics, including 'None' string handling)."""
    out: Dict[str, Optional[int]] = {}
    config = configparser.ConfigParser()
    try:
        config.read(config_file)
        for key, val in config.items("audio"):
            out[key] = None if val == "None" else int(val)
    except Exception:
        pass

    for key, default in DEFAULTS.items():
        out.setdefault(key, default)

    devices = get_audio_devices()
    if out["outputdevice"] is not None and out["outputdevice"] >= len(devices["output"]):
        out["outputdevice"] = None
    if out["inputdevice"] is not None and out["inputdevice"] >= len(devices["input"]):
        out["inputdevice"] = None
    return out


def save_audio_config(cfg: Dict[str, Optional[int]], config_file: str = CONFIG_FILE) -> None:
    config = configparser.ConfigParser()
    config.add_section("audio")
    for option, value in cfg.items():
        config.set("audio", option, str(value))
    with open(config_file, "w") as f:
        config.write(f)
