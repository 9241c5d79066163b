"""real_time_audio_sync_tpu_torch — the PyTorch/CUDA port of
``real_time_audio_sync_tpu``, for NVIDIA Hopper cards (H100).

It mirrors the JAX package's layout and public names, and imports neither
JAX nor the JAX package (whose ``__init__`` imports jax):

- ``features``  — the chroma frontend: framing, the real DFT as two
  matmuls, the in-repo chroma filterbank, L2 normalization.
- ``ops``       — the hand-written CUDA kernels (sources in ``csrc/``,
  built with ``nvcc`` at first use) beside their plain PyTorch versions.
- ``models``    — the online OTW/LiveNote/LiveNoteV2 engines on tensors
  (exported here under the JAX package's names), the fused streaming
  engine, offline DTW (dense wavefront and banded) and WTW (the host
  engine, ``AsyncWTW``, exported here, and the fused kernel's).
- ``streaming`` — hop framing and the live ``ScoreFollower``.
- ``eval``      — beat ground truth, the path scorer, field logs, the
  synthetic corpus, the pair and corpus runners and their CLI.
- ``parallel``  — multi-stream serving on one card (``MultiStreamFollower``,
  exported here, ``MultiStreamWTW`` and the fused followers).
- ``utils``     — wav IO, profiling, and state conversion to and from the
  JAX engine's layout.

Every entry point takes a ``device`` and runs on the card (``"cuda"``)
unless the caller asks for ``"cpu"``: a kernel runs where its tensors
live, and nothing falls back from the card to the CPU.
"""

from real_time_audio_sync_tpu_torch import numerics  # noqa: F401  (TF32 off, process-wide)
from real_time_audio_sync_tpu_torch.features.chroma import (  # noqa: F401
    wav_to_chroma,
    wav_to_chroma_col,
    wav_to_chroma_diff,
)
from real_time_audio_sync_tpu_torch.models import AsyncWTW, LiveNote, LiveNoteV2, OnlineTimeWarping  # noqa: F401
from real_time_audio_sync_tpu_torch.parallel import MultiStreamFollower  # noqa: F401

__version__ = "0.1.0"
