"""Multi-stream serving on one card: ``FusedMultiStreamFollower`` over the
K-insert kernel's grid of B streams, ``FusedMultiStreamWTW`` over the WTW
kernel's, and their status polling."""

from real_time_audio_sync_tpu_torch.parallel.serving import FusedMultiStreamFollower  # noqa: F401
from real_time_audio_sync_tpu_torch.parallel.wtw_serving import FusedMultiStreamWTW  # noqa: F401
