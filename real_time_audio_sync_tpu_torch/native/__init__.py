"""The native host runtime (``native/rtas_runtime.cpp`` at the repository
root): a lock-free ring buffer and a PCM16 wav decoder, through ctypes."""

from real_time_audio_sync_tpu_torch.native.bindings import (  # noqa: F401
    NativeRingBuffer,
    native_available,
    native_decode_wav,
)
