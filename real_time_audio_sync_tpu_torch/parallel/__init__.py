"""Multi-stream serving on one card: ``FusedMultiStreamFollower`` over the
K-insert kernel's grid of B streams, ``FusedMultiStreamWTW`` over the WTW
kernel's, and their status polling; ``MultiStreamFollower`` over the
online tensor engine's batched step, and ``MultiStreamWTW`` over
``AsyncWTW``'s block step with its windows batched through the wavefront
kernels."""

from real_time_audio_sync_tpu_torch.parallel.serving import (  # noqa: F401
    FusedMultiStreamFollower,
    MultiStreamFollower,
)
from real_time_audio_sync_tpu_torch.parallel.wtw_serving import FusedMultiStreamWTW, MultiStreamWTW  # noqa: F401
