"""ctypes bindings for the native host runtime (``native/rtas_runtime.cpp``
at the repository root, shared with the JAX package and left as it is).

This is host code, not a device path.  The shared library is built on
first use with the system ``g++`` into ``csrc/build/`` (ignored by git), or
into ``$RTAS_NATIVE_DIR`` when that is set, as the JAX package does.  The
library has a name of its own there (``librtas_runtime_torch.so``), and
the compiler writes a temporary file that is then renamed into place, so
parallel processes, and the JAX package's build in a shared directory,
never load a half-written library.  Every entry point has a pure-Python fallback, so
the package works without a compiler.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PACKAGE), "native", "rtas_runtime.cpp")
_LIB_DIR = os.environ.get("RTAS_NATIVE_DIR", os.path.join(_PACKAGE, "csrc", "build"))
_LIB_PATH = os.path.join(_LIB_DIR, "librtas_runtime_torch.so")

_lib = None
_build_lock = threading.Lock()
_build_failed = False


def _build() -> Optional[ctypes.CDLL]:
    global _build_failed
    if not os.path.exists(_SRC):
        _build_failed = True
        return None
    os.makedirs(_LIB_DIR, exist_ok=True)
    if not os.path.exists(_LIB_PATH) or os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC):
        tmp = f"{_LIB_PATH}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", tmp, _SRC]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, _LIB_PATH)
        except Exception:
            if os.path.exists(tmp):
                os.remove(tmp)
            _build_failed = True
            return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.rtas_ring_create.restype = ctypes.c_void_p
    lib.rtas_ring_create.argtypes = [ctypes.c_size_t]
    lib.rtas_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.rtas_ring_capacity.restype = ctypes.c_size_t
    lib.rtas_ring_capacity.argtypes = [ctypes.c_void_p]
    lib.rtas_ring_readable.restype = ctypes.c_size_t
    lib.rtas_ring_readable.argtypes = [ctypes.c_void_p]
    lib.rtas_ring_writable.restype = ctypes.c_size_t
    lib.rtas_ring_writable.argtypes = [ctypes.c_void_p]
    lib.rtas_ring_push.restype = ctypes.c_size_t
    lib.rtas_ring_push.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_size_t]
    lib.rtas_ring_pop.restype = ctypes.c_size_t
    lib.rtas_ring_pop.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_size_t]
    lib.rtas_wav_decode.restype = ctypes.c_int64
    lib.rtas_wav_decode.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.rtas_wav_frames.restype = ctypes.c_int64
    lib.rtas_wav_frames.argtypes = [ctypes.c_char_p]
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is None and not _build_failed:
        with _build_lock:
            if _lib is None and not _build_failed:
                _lib = _build()
    return _lib


def native_available() -> bool:
    return _get_lib() is not None


class NativeRingBuffer:
    """Lock-free SPSC float ring buffer (PortAudio-ring-buffer role,
    ims/audio.py:70-74) with a threading-safe pure-Python fallback."""

    def __init__(self, min_capacity: int):
        lib = _get_lib()
        if lib is not None:
            self._lib = lib
            self._ptr = lib.rtas_ring_create(min_capacity)
            self._fallback = None
        else:
            self._lib = None
            self._ptr = None
            import collections

            self._fallback = collections.deque()
            self._fallback_lock = threading.Lock()
            self._capacity = 1
            while self._capacity < max(min_capacity, 2):
                self._capacity *= 2

    @property
    def native(self) -> bool:
        return self._lib is not None

    @property
    def capacity(self) -> int:
        if self._lib:
            return int(self._lib.rtas_ring_capacity(self._ptr))
        return self._capacity

    def readable(self) -> int:
        if self._lib:
            return int(self._lib.rtas_ring_readable(self._ptr))
        with self._fallback_lock:
            return len(self._fallback)

    def push(self, samples: np.ndarray) -> int:
        """Write samples (producer side); returns how many were accepted."""
        buf = np.ascontiguousarray(samples, np.float32)
        if self._lib:
            return int(
                self._lib.rtas_ring_push(
                    self._ptr, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), buf.size
                )
            )
        with self._fallback_lock:
            n = min(buf.size, self._capacity - len(self._fallback))
            self._fallback.extend(buf[:n].tolist())
            return n

    def pop(self, n: int) -> np.ndarray:
        """Read up to n samples (consumer side)."""
        if self._lib:
            out = np.empty(n, np.float32)
            got = int(
                self._lib.rtas_ring_pop(
                    self._ptr, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n
                )
            )
            return out[:got]
        with self._fallback_lock:
            got = min(n, len(self._fallback))
            return np.asarray([self._fallback.popleft() for _ in range(got)], np.float32)

    def __del__(self):
        if getattr(self, "_lib", None) is not None and self._ptr:
            self._lib.rtas_ring_destroy(self._ptr)
            self._ptr = None


def native_decode_wav(path: str) -> Optional[Tuple[np.ndarray, int]]:
    """Decode a PCM16 wav to mono float32 via the native decoder; None when
    the native library is unavailable or the file isn't plain PCM16."""
    lib = _get_lib()
    if lib is None:
        return None
    n = lib.rtas_wav_frames(path.encode())
    if n < 0:
        return None
    out = np.empty(int(n), np.float32)
    rate = ctypes.c_int32(0)
    got = lib.rtas_wav_decode(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, ctypes.byref(rate)
    )
    if got < 0:
        return None
    return out[:got], int(rate.value)
