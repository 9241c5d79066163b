"""Multi-stream serving on one card: ``FusedMultiStreamFollower`` over the
K-insert kernel's grid of B streams, ``FusedMultiStreamWTW`` over the WTW
kernel's, and their status polling; ``MultiStreamFollower`` over the
online tensor engine's batched step."""

from real_time_audio_sync_tpu_torch.parallel.serving import (  # noqa: F401
    FusedMultiStreamFollower,
    MultiStreamFollower,
)
from real_time_audio_sync_tpu_torch.parallel.wtw_serving import FusedMultiStreamWTW  # noqa: F401
