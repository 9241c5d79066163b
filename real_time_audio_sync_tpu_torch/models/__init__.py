"""Alignment engines: the fused streaming OTW/LiveNote/LiveNoteV2 engine (``fused_streaming``), their shared core (``online_core``) and offline DTW (``dtw``)."""

from real_time_audio_sync_tpu_torch.models.dtw import DTW, dtw_auto  # noqa: F401
from real_time_audio_sync_tpu_torch.models.fused_streaming import (  # noqa: F401
    FusedStreamingEngine,
    fold_delta_tail,
    iter_delta_rows,
)
