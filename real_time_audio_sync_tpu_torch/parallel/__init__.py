"""Multi-stream serving on one card: ``FusedMultiStreamFollower`` over the
K-insert kernel's grid of B streams, and its status polling."""

from real_time_audio_sync_tpu_torch.parallel.serving import FusedMultiStreamFollower  # noqa: F401
