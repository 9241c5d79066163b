"""Alignment engines: the online OTW/LiveNote/LiveNoteV2 engines on tensors
(``otw``, ``livenote``, ``livenote_v2``) and the fused streaming engine
(``fused_streaming``), their shared core (``online_core``), offline DTW
(``dtw``), and windowed time warping — the host engine (``wtw``), the
device-resident block step (``wtw_async``) and the fused kernel
(``fused_wtw``)."""

from real_time_audio_sync_tpu_torch.models.dtw import DTW, dtw_auto  # noqa: F401
from real_time_audio_sync_tpu_torch.models.fused_streaming import (  # noqa: F401
    FusedStreamingEngine,
    fold_delta_tail,
    iter_delta_rows,
)
from real_time_audio_sync_tpu_torch.models.fused_wtw import FusedWTW  # noqa: F401
from real_time_audio_sync_tpu_torch.models.livenote import LiveNote  # noqa: F401
from real_time_audio_sync_tpu_torch.models.livenote_v2 import LiveNoteV2  # noqa: F401
from real_time_audio_sync_tpu_torch.models.otw import OnlineTimeWarping  # noqa: F401
from real_time_audio_sync_tpu_torch.models.wtw import WTW  # noqa: F401
from real_time_audio_sync_tpu_torch.models.wtw_async import AsyncWTW  # noqa: F401
