from real_time_audio_sync_tpu_torch.features.chroma import (  # noqa: F401
    chroma_from_samples,
    chroma_frames,
    chroma_pipeline,
    wav_to_chroma,
    wav_to_chroma_col,
)
from real_time_audio_sync_tpu_torch.features.filterbank import chroma_filterbank  # noqa: F401
