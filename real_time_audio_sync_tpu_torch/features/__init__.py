from real_time_audio_sync_tpu_torch.features.chroma import (  # noqa: F401
    chroma_diff_from_samples,
    chroma_frames,
    chroma_from_samples,
    chroma_pipeline,
    create_chroma,
    create_stft,
    wav_to_chroma,
    wav_to_chroma_col,
    wav_to_chroma_diff,
)
from real_time_audio_sync_tpu_torch.features.filterbank import chroma_filterbank  # noqa: F401
